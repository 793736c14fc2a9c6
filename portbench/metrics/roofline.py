"""A kernel's roofline share from the traced slice: its least time per
step (kernels/<b>.py and kernels/peaks.py) over its device time per step
(the trace's events of the kernel's symbol). Used by the
*_roofline readers; None where the trace holds no such kernel."""

import re

from portbench.kernels import peaks


def device_s_per_step(run, symbol):
    """Seconds of `symbol`'s kernels per traced step, or None."""
    if run.trace is None or not run.trace["steps"]:
        return None
    pat = re.compile(rf"\b{re.escape(symbol)}\b")
    total = sum(e - s for n, s, e in run.trace["ops"] if pat.search(n)) * 1e-6
    return total / run.trace["steps"] if total > 0 else None


def share(run, symbol, work):
    """100 x least seconds / measured seconds per step, or None."""
    measured = device_s_per_step(run, symbol)
    if measured is None:
        return None
    return 100.0 * peaks.bound_s(**work) / measured
