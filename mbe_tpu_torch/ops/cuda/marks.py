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

import torch

from . import build

REGIONS = ("bit_domain", "fsm", "synthesis", "commit", "end")

_INDEX = {r: i for i, r in enumerate(REGIONS)}
MARK = build.register(build.Kernel(None, build.CSRC / "marks.cu", "mbe_region_mark",
                                   [build.INT, build.PTR], None))


def mark(region: str, like: torch.Tensor):
    """Launch `region`'s mark on the current stream of like's device; no-op
    for a CPU tensor."""
    index = _INDEX[region]
    if like.device.type == "cuda":
        MARK.launch(like.device, index)
