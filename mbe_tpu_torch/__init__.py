"""mbe_tpu_torch — the PyTorch / CUDA port of mbe_tpu.

Same layout and module names as `mbe_tpu` (models/, ops/, utils/,
pipeline.py); state and band arrays keep the reference's channel-minor
layout, so every tensor compares one to one with its JAX counterpart.
The package imports torch and numpy only — never jax, never mbe_tpu.

Float32 matmuls are pinned to full precision at import: bf16-class
multiplies (TF32 on the GPU) put a ~49 dB floor on the log2Ml predictor
(docs/PERFORMANCE.md, "Precision policy").
"""

import torch

__version__ = "0.1.0"


def version_string() -> str:
    """mbe_versionString equivalent (mbelib.c:323-326)."""
    return __version__


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from . import pipeline  # noqa: E402
from .models.state import ChannelState, Parms, init_state  # noqa: E402

__all__ = ["pipeline", "ChannelState", "Parms", "init_state", "version_string"]
