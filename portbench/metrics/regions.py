"""Device time per region of the step, from the traced slice.

The program launches an empty kernel, `mbe_region_<region>`, where each
region of its step begins (mbe_tpu_torch/ops/cuda/marks.py): bit_domain,
fsm, synthesis, commit, and end where the step's body ends. A graph
replays them in program order. Walking the slice's device operations in
start order, each is summed into the region of the last mark before it (a
mark's own time into the region it opens); operations after `end`, or
before the slice's first mark, are outside the step (OUTSIDE): the
stream's copies, a sequence's per-frame copies. A program without marks
(no such kernel in the slice) reads None.
"""

import re

from portbench.trace_reader import mean_over_devices

MARK = re.compile(r"\bmbe_region_([a-z_]+)\b")
OUTSIDE = "outside"


def region_seconds(ops):
    """region -> device seconds of one device's `ops` ((name, start_us,
    end_us)), or None when no op is a mark."""
    totals, region, marked = {}, OUTSIDE, False
    for name, start, end in sorted(ops, key=lambda op: op[1]):
        m = MARK.search(name)
        if m:
            marked = True
            region = OUTSIDE if m.group(1) == "end" else m.group(1)
        totals[region] = totals.get(region, 0.0) + (end - start) * 1e-6
    return totals if marked else None


def busy_ms(run, region):
    """Device-busy ms per traced step (a replay in the batch cells, a tick
    in the stream cell) in `region`, the mean over the run's devices, or
    None."""
    def one(_, device):
        totals = region_seconds(device["ops"])
        return None if totals is None else 1e3 * totals.get(region, 0.0) / run.trace["steps"]
    return mean_over_devices(run.trace, one)
