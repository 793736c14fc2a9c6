"""Device-busy ms per tick outside the step (streaming): from the
mbe_region_end mark to the next bit_domain, the tick's upload and
readback copies; from the traced slice."""

from portbench.metrics.regions import OUTSIDE, busy_ms


def read(run):
    return busy_ms(run, OUTSIDE)
