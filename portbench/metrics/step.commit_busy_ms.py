"""Device-busy ms per step in the commit region (compiled step): the
invalid-lane rollback, the flags, int16 PCM, the state copied back, the
words or the bundle; from the traced slice."""

from portbench.metrics.regions import busy_ms


def read(run):
    return busy_ms(run, "commit")
