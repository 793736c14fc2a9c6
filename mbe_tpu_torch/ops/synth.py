"""Speech synthesis: phases, the voiced oscillator bank, unvoiced FFT +
WOLA, clipping (port of the IMBE main-path functions of
mbe_tpu.ops.synth; mbelib.c:891-1105, mbe_unvoiced_fft.c:714-761).

Band arrays are [57, C], buffers [256, C], audio [160, C]. The voiced
bank runs in the hand-written kernel of ops/cuda/voiced.py on the GPU.
"""

from functools import lru_cache

import numpy as np
import torch

from ..tables import T, table
from . import fft as fft_ops
from .cuda.voiced import voiced_sums
from .enhance import band_mask

FRAME = 160
FFT_SIZE = 256
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
WHITE_NOISE_SCALAR = float(np.float32(2.0 * np.pi / 53125.0))
SOFT_CLIP = float(np.float32((32767.0 * 0.95) / 7.0))
UNVOICED_SCALE_COEFF = float(np.float32(146.17696))
M_256_OVER_2PI = float(np.float32(256.0 / (2.0 * 3.14159265358979323846)))
MAX_SHORT = float(np.float32(32767.0 * 0.95))


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


# ---------------------------------------------------------------------------
# Phase update + model reconciliation (mbelib.c:912-951)
# ---------------------------------------------------------------------------

def reconcile_model_lengths(cur_L, cur_Ml, cur_Vl, prev_L, prev_Ml, prev_Vl):
    """eq 128/129 (mbelib.c:912-929): zero-fill Ml / set Vl=1 above the
    shorter model's L. Returns (maxl, cur_Ml, cur_Vl, prev_Ml, prev_Vl)."""
    maxl = torch.maximum(cur_L, prev_L)
    li = torch.arange(57, device=cur_L.device)[:, None]
    grow_prev = ((cur_L > prev_L)[None, :] & (li > prev_L[None, :])
                 & (li <= cur_L[None, :]))
    grow_cur = ((cur_L <= prev_L)[None, :] & (li > cur_L[None, :])
                & (li <= prev_L[None, :]))
    return (maxl,
            torch.where(grow_cur, 0.0, cur_Ml), torch.where(grow_cur, 1, cur_Vl),
            torch.where(grow_prev, 0.0, prev_Ml), torch.where(grow_prev, 1, prev_Vl))


def count_unvoiced(Vl, L):
    """numUv counts Vl[0..L] == 0 including index 0 (mbelib.c:901-910)."""
    li = torch.arange(57, device=L.device)[:, None]
    return ((li <= L[None, :]) & (Vl == 0)).sum(dim=0, dtype=torch.int32)


def fmodf_2pi(x):
    """Exact fmodf(x, 2pi_f32) for 0 <= x < 2^13, bit-identical to libm.

    Long-division ladder: subtract 2pi*2^k where it fits, k = 10..0. Each
    subtraction is Sterbenz-exact and 2pi*2^k is an exact power-of-two
    scaling, so the remainder is fmodf's. x - floor(x/y)*y rounds twice
    per wrap, and the PSIl chain compounds that (PARITY.md, "Worst-case
    SNR, root-caused").
    """
    for k in range(10, -1, -1):
        m = float(np.float32(TWO_PI * (1 << k)))
        x = torch.where(x >= m, x - m, x)
    return x


def update_phases(cur_w0, cur_L, cur_PSIl_old, cur_PHIl_old,
                  prev_w0, prev_PSIl, noise_buffer, num_uv):
    """mbe_update_speech_phases (mbelib.c:931-951) for l = 1..56; band 0
    of every phase array is left as it was.

    Returns (cur_PSIl, cur_PHIl, prev_PSIl_wrapped), all [57, C].
    noise_buffer: [256, C] f32 LCG samples (phase jitter reads 1..56).
    """
    li_i = torch.arange(57, device=cur_L.device)[:, None]
    li = li_i.to(torch.float32)
    psi_wrapped = fmodf_2pi(torch.abs(prev_PSIl)) * torch.sign(prev_PSIl)
    psi_wrapped = torch.where(psi_wrapped < 0.0, psi_wrapped + TWO_PI, psi_wrapped)

    cur_psi = psi_wrapped + (prev_w0 + cur_w0)[None, :] * ((li * 160.0) / 2.0)
    pl = WHITE_NOISE_SCALAR * noise_buffer[:57, :] - PI
    jitter = (num_uv.to(torch.float32)[None, :] * pl) / cur_L.to(torch.float32)[None, :]
    low = li_i <= torch.div(cur_L, 4, rounding_mode="floor")[None, :]
    cur_phi = torch.where(low, cur_psi, cur_psi + jitter)

    band0 = li_i == 0
    return (torch.where(band0, cur_PSIl_old, cur_psi),
            torch.where(band0, cur_PHIl_old, cur_phi),
            torch.where(band0, prev_PSIl, psi_wrapped))


# ---------------------------------------------------------------------------
# Voiced synthesis (mbelib.c:953-1040)
# ---------------------------------------------------------------------------

def render_voiced(cur_w0, cur_Ml, cur_Vl, cur_PHIl,
                  prev_w0, prev_Ml, prev_Vl, prev_PHIl, maxl):
    """Voiced component [160, C]: the windowed prev/cur oscillator banks
    (mbelib.c:970-1018) and the interpolated path for harmonics l < 8 of
    stable pitch (mbelib.c:953-968), as the inputs of voiced_sums: gains
    with every mask folded in, start phases, phase steps, and the
    interpolated path's amplitude lerp and quadratic phase
    theta_n = phi0 + alpha*n + q*n^2."""
    ws = table("Ws", cur_w0.device)  # [321]
    lcol = torch.arange(1, 57, device=cur_w0.device, dtype=torch.float32)[:, None]
    NI = 7
    lf7 = lcol[:NI]

    cur_v = cur_Vl[1:, :] == 1
    prev_v = prev_Vl[1:, :] == 1
    active = (lcol <= maxl[None, :]) & (cur_v | prev_v)
    # interpolation eligibility (JMBE #134-138): l < 8, both voiced, and
    # stable pitch
    use_interp7 = (cur_v[:NI] & prev_v[:NI]
                   & (torch.abs(cur_w0 - prev_w0) < 0.1 * cur_w0)[None, :])
    windowed = ~torch.cat([use_interp7, torch.zeros_like(cur_v[NI:])], dim=0)
    gain_prev = torch.where(prev_v & active & windowed, 2.0 * prev_Ml[1:, :], 0.0)
    gain_cur = torch.where(cur_v & active & windowed, 2.0 * cur_Ml[1:, :], 0.0)

    deltaphil2 = (cur_PHIl[1:NI + 1, :] - prev_PHIl[1:NI + 1, :]
                  - ((prev_w0 + cur_w0)[None, :] * lf7 * 160.0) / 2.0)
    deltawl2 = (1.0 / FRAME) * (
        deltaphil2 - TWO_PI * torch.floor((deltaphil2 + PI) / TWO_PI))
    gi2 = torch.where(use_interp7 & active[:NI], 2.0, 0.0)

    step_cur = cur_w0[None, :] * lcol
    return voiced_sums(
        gain_prev, prev_PHIl[1:, :].contiguous(), prev_w0[None, :] * lcol,
        gain_cur, cur_PHIl[1:, :] - step_cur * 160.0, step_cur,
        gi2 * prev_Ml[1:NI + 1, :],
        gi2 * (cur_Ml[1:NI + 1, :] - prev_Ml[1:NI + 1, :]) * (1.0 / FRAME),
        prev_PHIl[1:NI + 1, :].contiguous(),
        prev_w0[None, :] * lf7 + deltawl2,
        (cur_w0 - prev_w0)[None, :] * lf7 / (2.0 * FRAME),
        ws[FRAME:2 * FRAME], ws[:FRAME])


# ---------------------------------------------------------------------------
# Unvoiced FFT synthesis + WOLA (mbe_unvoiced_fft.c:714-761)
# ---------------------------------------------------------------------------

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


def unvoiced_fft(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer):
    """JMBE #117-126. Returns (unvoiced_add [160, C], new_previousUw
    [128, C]); band inputs [57, C], noise_buffer [256, C].

    previous_uw is the upper half of the reference's 256-sample buffer:
    the WOLA reads prevUw[n+128] only (mbe_unvoiced_fft.c:398-404).
    Band energies are a scatter-add of |X_k|^2 by band id and the band
    gains return to the bins by a gather; bins with no band (or a band
    above 56) go to a spare row 57. On the GPU the scatter-add's float
    atomics sum each band in no fixed order (ulp-level differences from
    run to run, far inside the 60 dB synthesis budget).
    """
    win256, w_prev, w_curr, denom = _windows(cur_w0.device)
    c = cur_w0.shape[0]
    reim = fft_ops.rfft256_packed(noise_buffer * win256)  # [258, C]
    Xre = reim[:fft_ops.NBINS, :]
    Xim = reim[fft_ops.NBINS:, :]

    # band edges (mbe_unvoiced_fft.c:643-661), for the bin counts
    mult = (M_256_OVER_2PI * cur_w0)[None, :]
    lf = torch.arange(57, device=cur_w0.device, dtype=torch.float32)[:, None]
    a_min = torch.clamp(torch.ceil((lf - 0.5) * mult), min=0.0)
    b_max = torch.clamp(torch.ceil((lf + 0.5) * mult), max=float(FFT_SIZE // 2))
    lmask = band_mask(cur_L) & (cur_Vl == 0)

    band = band_of_bins(cur_w0)
    row = torch.where((band >= 0.0) & (band <= 56.0), band, 57.0).long()
    mag2 = Xre * Xre + Xim * Xim                          # [129, C]
    numerator = torch.zeros((58, c), dtype=torch.float32, device=cur_w0.device)
    numerator = numerator.scatter_add_(0, row, mag2)[:57]

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
    curr_part = torch.cat([zeros32, uw_out[:128, :]])
    add = torch.where(denom > 1e-10, (w_prev * prev_part + w_curr * curr_part) / denom,
                      0.0)
    return add, uw_out[128:, :]


# ---------------------------------------------------------------------------
# Output conversion (mbelib.c:669-689, 1148-1321)
# ---------------------------------------------------------------------------

def clip_float(samples):
    """Soft clip at (32767*0.95)/7 in float scale (mbelib.c:669-689)."""
    return torch.clamp(samples, -SOFT_CLIP, SOFT_CLIP)


def float_to_short(samples):
    """mbe_floattoshort (mbelib.c:1148-1321): gain 7, clip ±32767*0.95,
    NaN -> 0, ±Inf -> ±clip, truncation toward zero like the C cast.
    The special values are written out: a cast of NaN or Inf is undefined
    in torch."""
    audio = torch.clamp(7.0 * samples, -MAX_SHORT, MAX_SHORT)
    audio = torch.where(torch.isinf(samples), torch.sign(samples) * MAX_SHORT, audio)
    audio = torch.where(torch.isnan(samples), 0.0, audio)
    return torch.trunc(audio).to(torch.int16)
