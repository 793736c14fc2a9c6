"""Region marks inside the step (csrc/marks.cu): one empty kernel per
region, so that a device trace splits a graphed step into its layers.

`mark(region, like)` says "from here on, device work belongs to
`region`". For a CUDA tensor `like` it launches the region's kernel on the
current stream of like's device, every time, eager or under a graph's
capture, so every graph of the step carries the marks in program order.
For a CPU tensor it does nothing. The regions, in a step's order:

    bit_domain  the body's start: unpack, lane validation, frame decode
                with its ECC, demodulation and B2
    fsm         parameter decode, spectral update, the repeat, mute and
                erasure FSM (AMBE enters it again for its state commits)
    synthesis   enhancement, comfort noise and the LCG, the speech core
                with B1 and B3, tones
    commit      the invalid-lane rollback, flags, int16 PCM, the state
                copied back, the words or the bundle
    end         the body's last line: device work after it and before
                the next bit_domain is outside the step
"""

import ctypes

import torch

from . import build

REGIONS = ("bit_domain", "fsm", "synthesis", "commit", "end")

SOURCE = build.CSRC / "marks.cu"

_INDEX = {r: i for i, r in enumerate(REGIONS)}
_FN = None


def load_library():
    """Build (if needed) and load the marks' library; returns the C entry
    point `mbe_region_mark` with its argument types set."""
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).mbe_region_mark
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def mark(region: str, like: torch.Tensor):
    """Launch `region`'s mark on the current stream of like's device; no-op
    for a CPU tensor."""
    index = _INDEX[region]
    device = like.device
    if device.type != "cuda":
        return
    fn = load_library()
    with torch.cuda.device(device):
        err = fn(index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"region mark {region!r}: CUDA error {err}")
