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

MARK = re.compile(r"\bmbe_region_([a-z_]+)\b")
OUTSIDE = "outside"


def region_seconds(ops):
    """region -> device seconds of `ops` ((name, start_us, end_us)), or None
    when no op is a mark."""
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
    in the stream cell) in `region`, or None."""
    t = run.trace
    if t is None or not t["steps"]:
        return None
    totals = region_seconds(t["ops"])
    if totals is None:
        return None
    return 1e3 * totals.get(region, 0.0) / t["steps"]
