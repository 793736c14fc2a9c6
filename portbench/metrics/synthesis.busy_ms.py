"""Device-busy ms per step in the synthesis region (synthesis):
enhancement, comfort noise and the LCG, the speech core with B1 and B3,
tones; from the traced slice."""

from portbench.metrics.regions import busy_ms


def read(run):
    return busy_ms(run, "synthesis")
