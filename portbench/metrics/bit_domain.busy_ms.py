"""Device-busy ms per step in the bit domain region (bit domain): from the
mbe_region_bit_domain mark to the next, in the traced slice: the tick's
device unpack, lane validation, the frame decode with its ECC,
demodulation and B2."""

from portbench.metrics.regions import busy_ms


def read(run):
    return busy_ms(run, "bit_domain")
