"""Share of the traced slice in which no operation ran on the device, in %
(device): 1 - union of the device operations' intervals / the slice; each
device's own, the mean over the run's devices."""

from portbench.trace_reader import mean_over_devices


def read(run):
    def one(_, device):
        if run.trace["window_s"] <= 0 or device["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - device["busy_s"] / run.trace["window_s"])
    return mean_over_devices(run.trace, one)
