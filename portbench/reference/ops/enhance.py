"""Spectral amplitude enhancement + adaptive smoothing over channel-minor
[57, C] lanes (port of mbe_tpu.ops.enhance; mbelib.c:412-666,
mbe_adaptive.c:151-256). Lanes with invalid L are handled with masks, and
erasure lanes (w0 == 0) are sanitized so they cannot put NaN or Inf into
the batch."""

import numpy as np
import torch

FLOAT_MAX = float(np.finfo(np.float32).max)
_096PI = float(np.float32(0.96 * np.pi))


def band_mask(L):
    """[57, C] bool: 1 <= l <= L."""
    li = torch.arange(57, device=L.device)[:, None]
    return (li >= 1) & (li <= L[None, :])


def spectral_amp_enhance(w0, L, Ml):
    """mbe_spectralAmpEnhanceWithRm0 (mbelib.c:641-661).

    Args: w0 [C] f32, L [C] i32, Ml [57, C] f32.
    Returns: (Ml_enhanced [57, C], rm0 [C]) — rm0 is the pre-enhancement
    spectral energy. Lanes with L outside [1, 56] come back unchanged with
    rm0 = 0 (the reference's early-out, mbelib.c:647-649).
    """
    valid = (L >= 1) & (L <= 56)
    mask = band_mask(L)
    w0s = torch.where(w0 > 1e-12, w0, 1.0)  # sanitize erasure lanes
    lf = torch.arange(57, device=w0.device, dtype=torch.float32)[:, None]

    cos_tab = torch.cos(w0s[None, :] * lf)
    Ml2 = torch.where(mask, Ml * Ml, 0.0)
    Rm0 = Ml2.sum(dim=0)
    Rm1 = (Ml2 * cos_tab).sum(dim=0)
    R2m0 = Rm0 * Rm0
    R2m1 = Rm1 * Rm1

    num = _096PI * ((R2m0 + R2m1)[None, :] - 2.0 * (Rm0 * Rm1)[None, :] * cos_tab)
    den = (w0s * Rm0 * (R2m0 - R2m1))[None, :]
    nz = den != 0.0
    ratio = torch.where(nz, num / torch.where(nz, den, 1.0), 1.0)
    ratio = torch.where(torch.isfinite(ratio) & (ratio >= 0.0), ratio, 1.0)
    Wl = torch.sqrt(torch.clamp(Ml, min=0.0)) * torch.sqrt(torch.sqrt(ratio))
    Wl = torch.where(torch.isfinite(Wl), Wl, 1.0)

    low_band = 8 * torch.arange(57, device=w0.device)[:, None] <= L[None, :]
    keep = low_band | (Ml == 0.0)
    Ml_w = torch.where(mask & ~keep, torch.clamp(Wl, 0.5, 1.2) * Ml, Ml)

    sum_sq = torch.where(mask, Ml_w * Ml_w, 0.0).sum(dim=0)
    zero = sum_sq == 0.0
    gamma = torch.where(zero, 1.0, torch.sqrt(Rm0 / torch.where(zero, 1.0, sum_sq)))
    Ml_out = torch.where(mask, gamma[None, :] * Ml_w, Ml_w)

    return (torch.where(valid[None, :], Ml_out, Ml),
            torch.where(valid, Rm0, 0.0))


def adaptive_smoothing(Ml, Vl, L, error_rate, error_total, error_count4,
                       prev_local_energy, prev_amplitude_threshold, rm0):
    """JMBE Algorithms #111-116 (mbe_applyAdaptiveSmoothingCore,
    mbe_adaptive.c:217-256). The voicing and threshold decisions compare
    floats; constants are the reference's f32 values and the evaluation
    order is the JAX package's.

    Returns (Ml', Vl', localEnergy', amplitudeThreshold' [C] i32).
    """
    mask = band_mask(L)

    # #111: local energy IIR with floor (mbe_adaptive.c:163-174)
    prev_e = torch.where(prev_local_energy < 10000.0, 75000.0, prev_local_energy)
    local_energy = torch.clamp(0.95 * prev_e + 0.05 * rm0, min=10000.0)

    # #112: adaptive threshold VM (mbe_adaptive.c:176-189)
    x8 = torch.sqrt(torch.sqrt(torch.sqrt(local_energy)))
    energy = x8 * x8 * x8
    vm_mid = (45.255 * energy) / torch.exp(277.26 * error_rate)
    vm_hi = 1.414 * energy
    vm = torch.where((error_rate <= 0.005) & (error_total <= 4), FLOAT_MAX,
                     torch.where((error_rate <= 0.0125) & (error_count4 == 0),
                                 vm_mid, vm_hi))

    # #113: force voiced where Ml > VM
    Vl_out = torch.where(mask & (Ml > vm[None, :]), 1, Vl)

    # #114: amplitude measure
    Am = torch.where(mask, Ml, 0.0).sum(dim=0)

    # #115: amplitude threshold (may go negative; mbe_adaptive.c:191-200)
    prev_t = torch.where(prev_amplitude_threshold <= 0, 20480,
                         prev_amplitude_threshold)
    tm = torch.where((error_rate <= 0.005) & (error_total <= 6), 20480,
                     6000 - 300 * error_total + prev_t).to(torch.int32)

    # #116: scale if Am exceeds threshold
    tmf = tm.to(torch.float32)
    do_scale = (Am > tmf) & (Am > 0.0)
    scale = tmf / torch.where(Am != 0.0, Am, 1.0)
    Ml_out = torch.where(mask & do_scale[None, :], Ml * scale[None, :], Ml)
    return Ml_out, Vl_out, local_energy, tm
