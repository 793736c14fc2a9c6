"""B2's share of its roofline per soft step, in % (bit domain): the least
time of all the step's launches over their device time."""

from portbench.kernels import b2
from portbench.metrics.roofline import share


def read(run):
    if not run.soft:
        return None
    return share(run, b2.SYMBOL, lambda channels: b2.work(run.codec, channels))
