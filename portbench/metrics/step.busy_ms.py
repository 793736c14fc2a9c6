"""Device-busy ms per step (a graph replay in the batch cells, a tick in
the stream cell), from the traced slice (compiled step); each device's
own, the mean over the run's devices."""

from portbench.trace_reader import mean_over_devices


def read(run):
    def one(_, device):
        return 1e3 * device["busy_s"] / run.trace["steps"] if device["busy_s"] > 0 else None
    return mean_over_devices(run.trace, one)
