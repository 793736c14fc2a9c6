"""CUDA graphs of one call over static buffers: the port's counterpart of
`jax.jit` with donated arguments.

`Captured(fn, device, warmup)` first runs `warmup()` once, eagerly, on a
side stream made on `device`. That fills the per-device constant caches
(`lru_cache` tables) and makes each kernel's one-time set-up on that
device, neither of which a capture may contain. It then captures `fn()`,
on the same stream, into a `torch.cuda.CUDAGraph`
(the default capture error mode, "global": any host-to-device upload or
synchronization inside `fn` raises). `fn` reads and writes only tensors
that outlive the graph (its static inputs and state); what it returns
lives in the graph's private memory pool, and each replay overwrites it.

The hand-written kernels count their launches in Python
(`ops/cuda/build.LAUNCHES`), and a replay runs no Python. The increase of
each count during the capture is the number of that kernel's nodes in the
graph (a count first made during the capture starts from 0): it is taken
back after the capture, which launches nothing, and added on every
replay. A capture that fails raises; nothing falls back to eager
execution. Each replay is a host span, `mbe.graph.replay`
(utils/spans.py).
"""

import dataclasses

import torch

from ..ops.cuda.build import LAUNCHES, counts
from .spans import span


def leaves(tree):
    """The tensors of a tensor, tuple, list, dict or dataclass tree, in a
    fixed order (fields in declaration order); anything else (None, a
    number) holds none."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (list, tuple)):
        return []
    return [x for sub in tree for x in leaves(sub)]


def copy_into(dst, src):
    """Copy each tensor of `src` into the tensor of `dst` at the same place,
    in place. A source that shares storage with any destination is cloned
    first, before any copy: the copies run in order, and a later one must
    not read what an earlier one wrote (a body that passes a leaf through
    or swaps two returns input tensors)."""
    if len(dst) != len(src):
        raise ValueError(f"copy_into: {len(dst)} destinations, {len(src)} sources")
    storages = {d.untyped_storage().data_ptr() for d in dst}
    src = [s.clone() if s is not d and s.untyped_storage().data_ptr() in storages else s
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"copy_into: {s.dtype} {tuple(s.shape)} into "
                             f"{d.dtype} {tuple(d.shape)}")
        if s is not d:
            d.copy_(s)


class Captured:
    """`fn()` captured into a CUDA graph on `device` (see the module
    docstring). `outputs` is what the captured call returned."""

    def __init__(self, fn, device, warmup):
        self.device = torch.device(device)
        if self.device.type != "cuda" or self.device.index is None:
            # "cuda" alone would capture and replay on whichever device is current
            raise ValueError(f"Captured needs a CUDA device with its index, got {device!r}")
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                warmup()
            torch.cuda.current_stream().wait_stream(side)
            before = counts()
            self.graph = torch.cuda.CUDAGraph()
            # on the side stream, made on this device: torch.cuda.graph's own
            # default stream is made once, on the device current at the first
            # capture in the process, and would move a later capture there
            with torch.cuda.graph(self.graph, stream=side):
                self.outputs = fn()
        self.launches = []  # (count, launches in the graph), the nonzero ones
        for name, count in LAUNCHES.items():
            start = before.get(name, 0)
            if count.n != start:
                self.launches.append((count, count.n - start))
            count.n = start

    def replay(self):
        """Replay on the current stream of `device`; the kernels' counts
        advance by their launches in the graph."""
        with span("mbe.graph.replay"), torch.cuda.device(self.device):
            self.graph.replay()
        for count, n in self.launches:
            count.n += n
