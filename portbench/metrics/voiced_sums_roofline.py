"""B1's share of its roofline, in % (synthesis)."""

from portbench.kernels import b1
from portbench.metrics.roofline import share


def read(run):
    return share(run, b1.SYMBOL, b1.work)
