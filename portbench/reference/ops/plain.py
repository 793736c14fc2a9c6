"""The closed forms of the three stages that the program runs in
hand-written kernels: the voiced oscillator bank, the unvoiced FFT + band
scaling + WOLA, and the exhaustive soft-decision ML search of a Golay or
Hamming block. Plain PyTorch: direct sums, DFT matmuls, a matmul over the
whole codebook and a min. Float32 with TF32 off (reference/__init__.py).
"""

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..tables import T, table
from . import fft as fft_ops
from .enhance import band_mask

FRAME = 160
FFT_SIZE = 256
NBANDS = 57
UW = 128
UNVOICED_SCALE_COEFF = float(np.float32(146.17696))
M_256_OVER_2PI = float(np.float32(256.0 / (2.0 * 3.14159265358979323846)))


# ---------------------------------------------------------------------------
# voiced oscillator bank (mbelib.c:953-1018)
# ---------------------------------------------------------------------------

def voiced_sums(gain_prev, phi_prev, step_prev, gain_cur, phi_cur0,
                step_cur, interp_amp0, interp_damp, interp_phi0,
                interp_alpha, interp_q, w_prev, w_cur):
    """Windowed voiced component [160, C] f32:

        out[n, c] = w_prev[n] * sum_l g_prev*cos(phi_prev + n*s_prev)
                  + w_cur[n]  * sum_l g_cur *cos(phi_cur0 + n*s_cur)
                  + sum_{l<7} (a0 + n*da) * cos(phi0 + alpha*n + q*n^2)

    gains, phases and steps [56, C]; the interpolated path [7, C]; the
    windows [160]."""
    n = torch.arange(FRAME, device=gain_prev.device, dtype=torch.float32)[None, :, None]

    def bank(g, phi, step):
        return (g[:, None, :] * torch.cos(phi[:, None, :] + step[:, None, :] * n)).sum(dim=0)

    theta = (interp_phi0[:, None, :] + interp_alpha[:, None, :] * n
             + interp_q[:, None, :] * n * n)
    interp = ((interp_amp0[:, None, :] + n * interp_damp[:, None, :])
              * torch.cos(theta)).sum(dim=0)
    return (w_prev[:, None] * bank(gain_prev, phi_prev, step_prev)
            + w_cur[:, None] * bank(gain_cur, phi_cur0, step_cur) + interp)


# ---------------------------------------------------------------------------
# unvoiced FFT + WOLA (mbe_unvoiced_fft.c:714-761)
# ---------------------------------------------------------------------------

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


def unvoiced_wola(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer):
    """DFT matmuls (ops/fft.py), band energies by a scatter-add of |X_k|^2
    by band id, band gains back to the bins by a gather; bins with no band
    (or a band above 56) go to a spare row 57. Returns (add [160, C], the
    new previousUw [128, C]); w0 [C], L [C], Ml and Vl [57, C],
    previous_uw [128, C], noise_buffer [256, C]."""
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


# ---------------------------------------------------------------------------
# soft-decision ML search (ecc.c:54-67, 157-215, 303-357)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Code:
    n: int
    data_lo: int
    shift_score: int
    shift_match: int
    shift_diff: int
    codebook: str   # the [ncw, n] codeword table in tables.npz


CODES = {
    "golay": Code(23, 11, 17, 16, 12, "golay_codewords"),
    "hamstd": Code(15, 0, 16, 15, 11, "hamming_codewords_std"),
    "ham7100": Code(15, 0, 16, 15, 11, "hamming_codewords_7100"),
}


def soft_decode_keys(bits, rel, idx_hard, code):
    """Winning int32 keys [R] over every codeword c of the code:

        key = (score << s_score) | ((c != idx_hard) << s_match)
              | (diffs << s_diff) | c
        score = sum_i rel_i * [bit_i != cw_i]
        diffs = Hamming distance of bits[data_lo:] from cw[data_lo:]

    whose order is the reference decoder's tie-break. By a float32 matmul
    over the whole codebook and a min; exact, since every product and sum
    is an integer below 2^24 and TF32 is off. bits, rel [R, n] (0/1 and
    0..255), idx_hard [R] the row's hard-decode codeword index."""
    spec = CODES[code]
    cw = table(spec.codebook, bits.device).to(torch.float32)   # [ncw, n]
    bits = bits.to(torch.int32)
    rel = rel.to(torch.int32)
    base = (rel * bits).sum(dim=-1, dtype=torch.int32)
    q = (rel * (1 - 2 * bits)).to(torch.float32)
    score = base[:, None] + (q @ cw.T).to(torch.int32)
    h = bits[:, spec.data_lo:].to(torch.float32)
    cwd = cw[:, spec.data_lo:]
    diffs = (h.sum(dim=-1)[:, None] + cwd.sum(dim=-1)[None, :]
             - 2.0 * (h @ cwd.T)).to(torch.int32)
    idx = torch.arange(cw.shape[0], dtype=torch.int32, device=bits.device)
    nomatch = (idx[None, :] != idx_hard.to(torch.int32)[:, None]).to(torch.int32)
    key = ((score << spec.shift_score) | (nomatch << spec.shift_match)
           | (diffs << spec.shift_diff) | idx)
    return key.amin(dim=-1)
