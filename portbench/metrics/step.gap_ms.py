"""ms per step in which the device idles between back-to-back replays
(compiled step): the span from the slice's first device operation to its
last, per step, less the busy time per step; each device's own, the mean
over the run's devices."""

from portbench.trace_reader import mean_over_devices


def read(run):
    def one(_, device):
        if device["first_us"] is None:
            return None
        span_s = (device["last_us"] - device["first_us"]) * 1e-6
        return 1e3 * (span_s - device["busy_s"]) / run.trace["steps"]
    return mean_over_devices(run.trace, one)
