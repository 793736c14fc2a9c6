"""Device-idle ms per step inside the program's mbe.graph.replay ranges
(device): the part of the traced slice's idle time during which the host
was in cudaGraphLaunch, per replay (batch) or tick (stream)."""

from portbench.metrics.program_spans import idle_in_ms


def read(run):
    return idle_in_ms(run, "mbe.graph.replay")
