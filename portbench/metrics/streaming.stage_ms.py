"""Host ms per tick in the program's mbe.stream.stage span (streaming):
host unpack when on, the copy into the pinned slot, the upload's enqueue;
total ns over count over the whole run from the program's counters
(some 8,100-9,550 ticks in 51 s, the 8 warm-up and 40 traced ticks
included)."""

from portbench.metrics.program_spans import mean_ms


def read(run):
    return mean_ms("mbe.stream.stage")
