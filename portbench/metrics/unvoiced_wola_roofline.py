"""B3's share of its roofline, in % (synthesis)."""

from portbench.kernels import b3
from portbench.metrics.roofline import share


def read(run):
    return share(run, b3.SYMBOL, b3.work)
