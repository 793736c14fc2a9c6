"""Drive the reference step over a sequence of ticks, from a fresh state.

Channels are independent, so a sample of them recomputed from tick 0 is a
complete check of those channels. On the card the reference step is
captured into a CUDA graph over static inputs and state (the arithmetic is
the eager step's; the graph only saves the host's launch cost per tick).
"""

import dataclasses

import numpy as np
import torch

from . import pipeline
from .models.state import init_state, map_state

RESULT_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors", "flags")


def leaves(state):
    """The tensors of a ChannelState in a fixed order."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.extend(leaves(v))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def unpack(packed, n_bits):
    """[C, S] uint8 packed MSB-first -> [C, n_bits] int32 0/1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_bits]


def set_tf32(on):
    """TF32 for float32 matmuls on (the control's precision) or off (the
    reference's)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


class Runner:
    """The reference decoder of `codec` for len(rng_seeds) channels, each
    channel seeded as the program's (mbe_setThreadRngSeed per channel).
    A call takes one tick's frame [S, rows, cols] (0/1) and reliabilities
    (or None) and returns (pcm [S, 160] int16, result words [S, 5] int32,
    columns in RESULT_KEYS order), static outputs the next call
    overwrites."""

    def __init__(self, codec, soft, carry_enh, rng_seeds, device, tf32=False):
        set_tf32(tf32)
        self.codec, self.soft = codec, soft
        device = torch.device(device)
        s = len(rng_seeds)
        self.state = init_state(s, np.asarray(rng_seeds, np.int64), carry_enh=carry_enh,
                                device=device)
        shape = (s, *pipeline.FRAME_SHAPES[codec])
        self.frame = torch.zeros(shape, dtype=torch.int32, device=device)
        self.rel = torch.zeros(shape, dtype=torch.int32, device=device) if soft else None
        self.graph = None
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._body(map_state(torch.clone, self.state))
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._body(self.state)

    def _body(self, state):
        new_state, pcm, res, _ = pipeline.step_int16(self.codec, self.frame, state, self.rel)
        dst, src = leaves(state), leaves(new_state)
        # a new leaf may be an old one (prev' = cur): clone every source that
        # shares storage with a destination before the first copy
        storages = {d.untyped_storage().data_ptr() for d in dst}
        src = [x.clone() if x is not d and x.untyped_storage().data_ptr() in storages else x
               for d, x in zip(dst, src)]
        for d, x in zip(dst, src):
            if x is not d:
                d.copy_(x)
        return pcm, torch.stack([res[k].to(torch.int32) for k in RESULT_KEYS], dim=1)

    def __call__(self, frame, rel=None):
        self.frame.copy_(frame)
        if self.soft:
            self.rel.copy_(rel)
        if self.graph is None:
            self.out = self._body(self.state)
        else:
            self.graph.replay()
        return self.out


def run_sequence(runner, frames_of, n_ticks, keep=None):
    """The reference over ticks 0..n_ticks-1: frames_of(t) gives tick t's
    (frame, rel or None) for the runner's channels. Returns (pcm [T, S,
    160] int16, words [T, S, 5] int32) as numpy arrays, of the channels
    `keep` (indices; all when None)."""
    s = runner.frame.shape[0] if keep is None else len(keep)
    device = runner.frame.device
    if keep is not None:
        keep = torch.as_tensor(keep, device=device)
    pcm = torch.empty((n_ticks, s, 160), dtype=torch.int16, device=device)
    words = torch.empty((n_ticks, s, len(RESULT_KEYS)), dtype=torch.int32, device=device)
    for t in range(n_ticks):
        p, w = runner(*frames_of(t))
        if keep is not None:
            p, w = p.index_select(0, keep), w.index_select(0, keep)
        pcm[t].copy_(p)
        words[t].copy_(w)
    return pcm.cpu().numpy(), words.cpu().numpy()
