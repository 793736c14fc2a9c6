"""A kernel's roofline share from the traced slice: its least time per
step (kernels/<b>.py and kernels/peaks.py) over its device time per step
(the trace's events of the kernel's symbol), device by device, each
device's least work sized by its own share of the channels, as
torch.tensor_split cuts them in mbe_tpu_torch/parallel/sharding.py; the
mean over the run's devices. Used by the *_roofline readers; None where
the trace holds no such kernel on a device."""

import re

import torch

from portbench.kernels import peaks
from portbench.trace_reader import mean_over_devices


def device_channels(channels, devices):
    """Channels of each of `devices` devices: torch.tensor_split's parts."""
    return [len(p) for p in torch.tensor_split(torch.arange(channels), devices)]


def device_s_per_step(run, device, symbol):
    """Seconds of `symbol`'s kernels per traced step on one device (its
    reading in the trace), or None."""
    pat = re.compile(rf"\b{re.escape(symbol)}\b")
    total = sum(e - s for n, s, e in device["ops"] if pat.search(n)) * 1e-6
    return total / run.trace["steps"] if total > 0 else None


def share(run, symbol, work):
    """100 x least seconds / measured seconds per step, the mean over the
    run's devices, or None. `work(channels)` is the kernel's least work
    at a device's channels."""
    def one(i, device):
        measured = device_s_per_step(run, device, symbol)
        if measured is None:
            return None
        channels = device_channels(run.channels, len(run.trace["devices"]))[i]
        return 100.0 * peaks.bound_s(**work(channels)) / measured
    return mean_over_devices(run.trace, one)
