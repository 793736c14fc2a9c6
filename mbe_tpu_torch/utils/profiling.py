"""Profiling helpers (port of mbe_tpu.utils.profiling): a torch.profiler
trace and steady-state time per iteration, and the program's host spans
(`span`, `snapshot`: utils/spans.py).

The reference's measurement protocol carries over: TWO run lengths, each
ended by a real host readback (`force`), and the time per iteration is
the SLOPE between them, which cancels every per-run constant (launch,
readback, the first replay's set-up). The reference learned that a
completion flag alone is not proof that the work is done: only a value
fetched to the host is (mbe_tpu/utils/profiling.py:7-22).

On the card, `device_time` captures one `carry -> body(carry)` into a
CUDA graph (utils/graphs.py) with the carry copied back in place and
replays it n times: the counterpart of the reference's jitted `lax.scan`,
with no host launch cost per iteration. On the CPU it loops eagerly.
"""

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from . import graphs
from .spans import snapshot, span  # noqa: F401  (the program's host spans)


@contextlib.contextmanager
def trace(logdir):
    """Profile the block with torch.profiler (host and, when a card is
    present, CUDA activities) and write a Chrome trace into `logdir`.
    Yields the profiler (its `events()` and `key_averages()` can be read
    after the block)."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / f"trace_{time.time_ns()}.json"))


def force(out):
    """Wait until `out` is really computed: fetch one element of its first
    tensor leaf to the host, and return it (a Python number)."""
    return graphs.leaves(out)[0].reshape(-1)[0].item()


def _map(fn, tree):
    """`tree` with each tensor leaf replaced by fn(leaf) (the structure of
    graphs.leaves; other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def device_time(body, carry0, iters: int = 50, warmup: bool = True,
                short_iters: int | None = None, reps: int = 3) -> float:
    """Seconds per iteration of `body` (carry -> carry of the same
    structure, shapes and dtypes): the slope between a short and a long
    run, each ended by `force`, the fastest of `reps` runs of each (see
    the module docstring). `warmup` is kept for the reference's signature;
    the first runs of each length always warm up. `carry0` is not
    modified."""
    n2 = iters
    n1 = short_iters if short_iters is not None else max(2, iters // 5)
    first = graphs.leaves(carry0)[0]
    if first.device.type == "cuda":
        static = _map(torch.clone, carry0)

        def once():
            graphs.copy_into(graphs.leaves(static), graphs.leaves(body(static)))

        graph = graphs.Captured(once, first.device,
                                warmup=lambda: body(_map(torch.clone, carry0)))

        def run(n):
            graphs.copy_into(graphs.leaves(static), graphs.leaves(carry0))
            for _ in range(n):
                graph.replay()
            return static
    else:
        def run(n):
            carry = carry0
            for _ in range(n):
                carry = body(carry)
            return carry

    force(run(n1))
    force(run(n2))
    t1 = t2 = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        force(run(n1))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        force(run(n2))
        t2 = min(t2, time.perf_counter() - t0)
    return max(t2 - t1, 0.0) / (n2 - n1)
