"""Device-busy ms per replay outside the step (batch entry): from the
mbe_region_end mark to the next bit_domain, run_sequence's per-frame copy
in and copies out (and, once per call, its state copies and the
consumer); from the traced slice."""

from portbench.metrics.regions import OUTSIDE, busy_ms


def read(run):
    return busy_ms(run, OUTSIDE)
