"""Host ms per graph replay (compiled step): the program's
mbe.graph.replay span, its cudaGraphLaunch, total ns over count over the
whole run from the program's counters, traced or not. A 51 s run holds
some 8,100-9,550 ticks (stream) or 7,000-9,300 replays (batch), set-up's
8 warm-up ticks or 50 warm-up replays and the 40 traced ticks or 50
traced replays included."""

from portbench.metrics.program_spans import mean_ms


def read(run):
    return mean_ms("mbe.graph.replay")
