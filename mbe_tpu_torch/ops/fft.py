"""256-point real DFT pair as float32 matmuls over channel-minor columns
(port of mbe_tpu.ops.fft). Full float32: the package pins TF32 off."""

from functools import lru_cache

import numpy as np
import torch

N = 256
NBINS = N // 2 + 1


@lru_cache(maxsize=1)
def _mats():
    """Forward [258, 256] ([cos | -sin] rows) and inverse [256, 258]
    (numpy irfft semantics, no imaginary part at bins 0 and 128)."""
    n = np.arange(N)[:, None]
    k = np.arange(NBINS)[None, :]
    ang = 2.0 * np.pi * n * k / N
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).T
    w = np.full(NBINS, 2.0)
    w[0] = w[NBINS - 1] = 1.0
    inv = np.concatenate([(w[:, None] * np.cos(ang.T)) / N,
                          (-w[:, None] * np.sin(ang.T)) / N], axis=0).T
    return (np.ascontiguousarray(fwd, np.float32),
            np.ascontiguousarray(inv, np.float32))


@lru_cache(maxsize=None)
def _dev_mats(device):
    fwd, inv = _mats()
    return torch.as_tensor(fwd, device=device), torch.as_tensor(inv, device=device)


def rfft256_packed(x):
    """x [256, C] f32 -> reim [258, C] = [re (129) | im (129)]."""
    return _dev_mats(x.device)[0] @ x


def irfft256_packed(reim):
    """reim [258, C] ([re | im]) -> x [256, C] f32."""
    return _dev_mats(reim.device)[1] @ reim
