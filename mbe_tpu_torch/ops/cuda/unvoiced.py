"""Unvoiced synthesis (FFT + band scaling + WOLA, mbe_unvoiced_fft.c:714-761):
the hand-written CUDA kernel (csrc/unvoiced.cu) and its plain PyTorch
version.

Per channel: the windowed LCG noise's 256-point real DFT, per-band
energies over the bins of each band, band scalors 146.17696*Ml/sqrt(mean)
on the unvoiced bands 1..L, the scaled inverse DFT, and the WOLA combine
with the previous frame's Uw. `unvoiced_wola` launches the kernel; its
one caller, ops/synth.unvoiced_fft, runs `unvoiced_wola_reference` for
CPU tensors instead.
"""

from functools import lru_cache

import numpy as np
import torch

from ...tables import T
from .. import fft as fft_ops
from ..enhance import band_mask
from . import build

FRAME = 160
FFT_SIZE = 256
NBANDS = 57
UW = 128
UNVOICED_SCALE_COEFF = float(np.float32(146.17696))
M_256_OVER_2PI = float(np.float32(256.0 / (2.0 * 3.14159265358979323846)))

KERNEL = build.register(build.Kernel("unvoiced_wola", build.CSRC / "unvoiced.cu",
                                     "mbe_unvoiced_wola",
                                     [build.PTR] * 13 + [build.INT, build.PTR], None))


def _wola_weights():
    """WOLA weight vectors (mbe_unvoiced_fft.c:159-170)."""
    ws = np.asarray(T.Ws_synthesis, np.float32)  # [211], index n+105

    def win(n):
        return ws[n + 105] if -105 <= n <= 105 else np.float32(0.0)

    w_prev = np.array([win(n) for n in range(FRAME)], np.float32)
    w_curr = np.array([win(n - FRAME) for n in range(FRAME)], np.float32)
    return w_prev, w_curr, w_prev * w_prev + w_curr * w_curr


def _synthesis_window_256():
    """256-tap window centered at 128 (mbe_unvoiced_fft.c:172-175)."""
    ws = np.asarray(T.Ws_synthesis, np.float32)
    out = np.zeros(FFT_SIZE, np.float32)
    for i in range(FFT_SIZE):
        if -105 <= i - 128 <= 105:
            out[i] = ws[i - 128 + 105]
    return out


@lru_cache(maxsize=None)
def _windows(device):
    """(win256 [256, 1], w_prev, w_curr, denom [160, 1]) on `device`."""
    return tuple(torch.as_tensor(a, device=device)[:, None]
                 for a in (_synthesis_window_256(), *_wola_weights()))


@lru_cache(maxsize=None)
def _cos_table(device):
    """cos(2 pi i / 256), i < 256, float32 of the float64 value (the
    entries of ops/fft.py's DFT matrices)."""
    return torch.as_tensor(np.cos(2.0 * np.pi * np.arange(FFT_SIZE) / FFT_SIZE).astype(np.float32),
                           device=device)


def band_of_bins(cur_w0):
    """Exact per-bin band id [129, C] (f32; -1 = no band).

    The band intervals tile the bins contiguously, b_max[l] =
    ceil((l+0.5)*mult) = a_min[l+1] (mbe_unvoiced_fft.c:643-661), so bin
    k's band is floor(k/mult + 0.5) up to f32 rounding at the edges; two
    correction rounds against the reference's own f32 edge expressions
    make the assignment match its ceil-based membership bit for bit.
    """
    m = (M_256_OVER_2PI * cur_w0)[None, :]
    kf = torch.arange(FFT_SIZE // 2 + 1, device=cur_w0.device,
                      dtype=torch.float32)[:, None]
    safe = m > 0.0
    band = torch.floor(kf / torch.where(safe, m, 1.0) + 0.5)
    for _ in range(2):
        lo = torch.ceil((band - 0.5) * m)
        hi = torch.ceil((band + 0.5) * m)
        band = band + (kf >= hi).to(torch.float32) - (kf < lo).to(torch.float32)
    # the reference clamps b_max to 128, so bin 128 belongs to no band
    return torch.where(safe & (kf < FFT_SIZE // 2), band, -1.0)


def unvoiced_wola_reference(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer):
    """The plain version: DFT matmuls (ops/fft.py), band energies by a
    scatter-add of |X_k|^2 by band id, band gains back to the bins by a
    gather; bins with no band (or a band above 56) go to a spare row 57.
    Shapes as unvoiced_wola. On the GPU the scatter-add's float atomics
    sum each band in no fixed order (ulp-level differences from run to
    run)."""
    win256, w_prev, w_curr, denom = _windows(cur_w0.device)
    c = cur_w0.shape[0]
    reim = fft_ops.rfft256_packed(noise_buffer * win256)  # [258, C]
    Xre = reim[:fft_ops.NBINS, :]
    Xim = reim[fft_ops.NBINS:, :]

    # band edges (mbe_unvoiced_fft.c:643-661), for the bin counts
    mult = (M_256_OVER_2PI * cur_w0)[None, :]
    lf = torch.arange(NBANDS, device=cur_w0.device, dtype=torch.float32)[:, None]
    a_min = torch.clamp(torch.ceil((lf - 0.5) * mult), min=0.0)
    b_max = torch.clamp(torch.ceil((lf + 0.5) * mult), max=float(FFT_SIZE // 2))
    lmask = band_mask(cur_L) & (cur_Vl == 0)

    band = band_of_bins(cur_w0)
    row = torch.where((band >= 0.0) & (band <= 56.0), band, 57.0).long()
    mag2 = Xre * Xre + Xim * Xim                          # [129, C]
    numerator = torch.zeros((NBANDS + 1, c), dtype=torch.float32, device=cur_w0.device)
    numerator = numerator.scatter_add_(0, row, mag2)[:NBANDS]

    bin_count = b_max - a_min
    ok = lmask & (bin_count > 0) & (numerator > 1e-10)
    mean = numerator / torch.where(bin_count > 0, bin_count, 1.0)
    scalor = UNVOICED_SCALE_COEFF * cur_Ml / torch.sqrt(torch.where(mean > 0, mean, 1.0))
    scalor = torch.where(ok, scalor, 0.0)
    spare = torch.zeros((1, c), dtype=torch.float32, device=cur_w0.device)
    bin_scalor = torch.gather(torch.cat([scalor, spare]), 0, row)  # [129, C]
    uw_out = fft_ops.irfft256_packed(reim * torch.cat([bin_scalor, bin_scalor]))

    # WOLA combine (mbe_unvoiced_fft.c:343-530)
    zeros32 = torch.zeros((32, c), dtype=torch.float32, device=cur_w0.device)
    prev_part = torch.cat([previous_uw, zeros32])
    curr_part = torch.cat([zeros32, uw_out[:UW, :]])
    add = torch.where(denom > 1e-10, (w_prev * prev_part + w_curr * curr_part) / denom, 0.0)
    return add, uw_out[UW:, :]


def unvoiced_wola(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer):
    """Unvoiced component: (add [160, C], new_previousUw [128, C]) f32.

    Args (channel-minor, contiguous, any C):
      cur_w0 [C] f32, cur_L [C] i32, cur_Ml [57, C] f32, cur_Vl [57, C] i32;
      previous_uw [128, C] f32: the upper half of the reference's
        256-sample buffer, the only part the WOLA reads
        (mbe_unvoiced_fft.c:398-404);
      noise_buffer [256, C] f32: the frame's LCG samples (unwindowed).
    """
    c = cur_w0.shape[-1]
    f32, i32 = torch.float32, torch.int32
    args = (cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer)
    specs = (("cur_w0", f32, (c,)), ("cur_L", i32, (c,)), ("cur_Ml", f32, (NBANDS, c)),
             ("cur_Vl", i32, (NBANDS, c)), ("previous_uw", f32, (UW, c)),
             ("noise_buffer", f32, (FFT_SIZE, c)))
    device = build.check("unvoiced_wola", [(name, x, dtype, shape)
                                           for x, (name, dtype, shape) in zip(args, specs)])
    add = torch.empty((FRAME, c), dtype=f32, device=device)
    new_uw = torch.empty((UW, c), dtype=f32, device=device)
    KERNEL.launch(device, *args, _cos_table(device), *_windows(device), add, new_uw, c)
    return add, new_uw
