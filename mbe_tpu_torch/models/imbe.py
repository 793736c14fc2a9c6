"""IMBE 7200x4400 frame ECC/demod, IMBE 4400 parameter decode and the
frame FSM (port of mbe_tpu.models.imbe, hard 7200 path).

The per-L bit-allocation scatter (bo/ba/hoba/ImbeJi, 48 layouts) becomes
host tables indexed by L9 = L - 9 with gathers; every frame-type branch
is a lane-wise select.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..ops import demod, ecc, noise
from ..ops.bits import lookup
from ..ops.enhance import spectral_amp_enhance
from ..tables import T, table
from . import spectral
from .speech import synthesize_speech_core
from .state import MUTING_THRESHOLD_IMBE, Parms, imbe_headroom_reset, select_cases

_POW2_23 = np.array([1 << i for i in range(23)], np.int64)

# 7200-layout imbe_d fields (base, length): C0 data, 3x Golay data, 3x
# Hamming data, 7 raw bits (imbe7200x4400.c:469-515). The packed words
# store field bit t at position base+t ("field forward").
_FIELDS_7200 = ((0, 12), (12, 12), (24, 12), (36, 12),
                (48, 11), (59, 11), (70, 11), (81, 7))
_NCOLS = 72  # 12 bb[1] voicing bits + 1 b2 + 5 gains + 54 HOC codes


@lru_cache(maxsize=1)
def _decode_tables():
    """Host-precomputed layouts for the 48 distinct L values
    (mbe_tpu.models.imbe._decode_tables, the forms this port reads).

    Field columns of the bb[58][12] scatter (imbe7200x4400.c:156-168):
      0..11  bb[1][t] voicing source bits, one bit per column
      12     b2 gain index (weights 2^t)
      13..17 gain codes bm for i=2..6
      18..71 HOC codes bm for (i, k-2), i in 0..5, k-2 in 0..8
    Every input bit lands in exactly one (column, bit t) slot; `slot_pos`
    [S, 48] is the field-forward packed position slot s reads under each
    L9 (95 = a bit that is always zero), `slot_col`/`slot_t` its column
    and bit. The Tl block IDCT (imbe7200x4400.c:251-270) is factored into
    the per-block-size matrices `M100` and the band->slot map `scl`.
    """
    Ji = np.asarray(T.ImbeJi)
    hoba = np.asarray(T.hoba)
    idct = np.asarray(T.imbe_idct_cos)
    bo = np.asarray(T.bo)
    ba = np.asarray(T.ba)

    src = np.full((48, 58, 12), -1, np.int32)  # bb[row][t] <- d[6+n]
    for L9 in range(48):
        for n in range(79):
            src[L9, bo[L9, n, 0], bo[L9, n, 1]] = 6 + n

    pos = np.full((48, _NCOLS, 12), -1, np.int32)  # imbe_d index per slot
    m_valid = np.zeros((48, 54), bool)
    hoc_qfac = np.zeros((48, 54), np.float32)   # quantstep*standdev
    hoc_off = np.zeros((48, 54), np.float32)    # exp2f(Bm-1)
    gain_bits = ba[:, :, 0].astype(np.int32)    # [48, 5]
    qs = np.asarray(T.quantstep)
    sd = np.asarray(T.standdev)
    for L9 in range(48):
        for t in range(12):  # voicing bit t is all of column t
            pos[L9, t, 0] = src[L9, 1, t]
        for t in range(6):
            pos[L9, 12, t] = src[L9, 2, t]
        for i in range(2, 7):
            for t in range(gain_bits[L9, i - 2]):
                pos[L9, 13 + i - 2, t] = src[L9, i + 1, t]
        m = 8
        for i in range(6):
            for k in range(2, Ji[L9, i] + 1):
                slot = i * 9 + (k - 2)
                Bm = hoba[L9, m - 8]
                if Bm > 0:
                    m_valid[L9, slot] = True
                    for t in range(Bm):
                        pos[L9, 18 + slot, t] = src[L9, m, t]
                    hoc_qfac[L9, slot] = np.float32(qs[Bm - 1]) * np.float32(sd[k - 2])
                    hoc_off[L9, slot] = np.float32(2.0) ** np.float32(Bm - 1)
                m += 1

    # imbe_d[base+o] of a field of length ln is field bit ln-1-o, which the
    # field-forward words hold at base+t
    p88 = np.zeros(88, np.int32)
    for base, ln in _FIELDS_7200:
        for o in range(ln):
            p88[base + o] = base + (ln - 1 - o)
    slot_pos, slot_col, slot_t = [], [], []
    for col in range(_NCOLS):
        for t in range(12):
            pv = pos[:, col, t]
            if (pv >= 0).any():
                slot_pos.append(np.where(pv >= 0, p88[np.maximum(pv, 0)], 95))
                slot_col.append(col)
                slot_t.append(t)

    Midct = np.zeros((10, 110), np.float32)  # [k-1, ji*10 + j-1]
    for ji in range(1, 11):
        for j in range(1, ji + 1):
            for k in range(1, ji + 1):
                ak = 1.0 if k == 1 else 2.0
                Midct[k - 1, ji * 10 + (j - 1)] = ak * idct[ji, j, k]
    M100 = Midct.reshape(10, 11, 10).transpose(1, 0, 2).reshape(11, 100)
    # per-lane rows by the low block size v = L // 6 (1..9; else zeros)
    m_lo = np.zeros((11, 100), np.float32)
    m_hi = np.zeros((11, 100), np.float32)
    m_lo[1:10] = M100[1:10]
    m_hi[1:10] = M100[2:11]
    scl = np.full((48, 57), -1, np.int64)
    for L9 in range(48):
        l = 1
        for i in range(6):
            for j in range(1, Ji[L9, i] + 1):
                scl[L9, l] = i * 10 + (j - 1)
                l += 1

    ri_cos = np.asarray(T.imbe_ri_cos)
    RiM = np.zeros((6, 6), np.float32)  # [m-1, i-1]
    for m in range(1, 7):
        for i in range(1, 7):
            RiM[m - 1, i - 1] = (1.0 if m == 1 else 2.0) * ri_cos[m, i]

    return dict(
        slot_pos=np.stack(slot_pos).astype(np.int64),        # [S, 48]
        slot_col=np.asarray(slot_col, np.int64),             # [S]
        slot_t=np.asarray(slot_t, np.int64),                 # [S]
        gain_step=ba[:, :, 1].astype(np.float32).T.copy(),   # [5, 48]
        gain_off=(2.0 ** (gain_bits - 1)).astype(np.float32).T.copy(),
        hoc_qfac=hoc_qfac.T.copy(), hoc_off=hoc_off.T.copy(),  # [54, 48]
        m_valid=m_valid.T.copy(),
        m_lo=m_lo.T.copy(), m_hi=m_hi.T.copy(),              # [100, 11]
        scl=scl.T.copy(),                                    # [57, 48]
        RiM_T=RiM.T.copy())                                  # [6, 6]


@lru_cache(maxsize=None)
def _decode_consts(device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in _decode_tables().items()}


def _words_from_fields_7200(c0d, g0, g1, g2, h0, h1, h2, raw7):
    """Assemble the 3 field-forward packed words from per-field packed
    integers (12/12/12/12/11/11/11/7 bits, already shifted to bit 0).
    int64, so word 0's bit 31 stays a plain bit."""
    c0d, g0, g1, g2, h0, h1, h2, raw7 = (
        x.to(torch.int64) for x in (c0d, g0, g1, g2, h0, h1, h2, raw7))
    w0 = c0d | (g0 << 12) | ((g1 & 0xFF) << 24)
    w1 = (g1 >> 8) | (g2 << 4) | (h0 << 16) | ((h1 & 0x1F) << 27)
    w2 = (h1 >> 5) | (h2 << 6) | (raw7 << 17)
    return w0, w1, w2


def _extract_bits(word, hi, lo):
    """[hi-lo+1, C] bits of a packed word [C], MSB (bit `hi`) first."""
    shifts = torch.arange(hi, lo - 1, -1, device=word.device)[:, None]
    return (word[None, :] >> shifts) & 1


def expand_imbe_d(words):
    """Field-forward packed words -> [88, C] int32 imbe_d bit planes (the
    layout of imbe7200x4400.c:469-515)."""
    w0, w1, w2 = words
    fields = (w0 & 0xFFF, (w0 >> 12) & 0xFFF,
              ((w0 >> 24) & 0xFF) | ((w1 & 0xF) << 8), (w1 >> 4) & 0xFFF,
              (w1 >> 16) & 0x7FF, ((w1 >> 27) & 0x1F) | ((w2 & 0x3F) << 5),
              (w2 >> 6) & 0x7FF, (w2 >> 17) & 0x7F)
    parts = [_extract_bits(f, ln - 1, 0)
             for f, (_, ln) in zip(fields, _FIELDS_7200)]
    return torch.cat(parts, dim=0).to(torch.int32)


def pack_imbe_words(imbe_d):
    """[88, C] int bit planes -> the 3 field-forward packed words (int64):
    the inverse of expand_imbe_d."""
    d = imbe_d.to(torch.int64)
    words = [torch.zeros_like(d[0]) for _ in range(3)]
    for base, ln in _FIELDS_7200:
        for o in range(ln):
            p = base + ln - 1 - o
            words[p // 32] = words[p // 32] | (d[base + o] << (p % 32))
    return tuple(words)


def _b0_from_words_7200(words):
    """b0 (8-bit fundamental index): imbe_d[0..5] at w0 bits 11..6 and
    imbe_d[85..86] at w2 bits 19..18."""
    w0, _, w2 = words
    return (((w0 >> 6) & 63) << 2) | ((w2 >> 18) & 3)


def decode_imbe4400_parms(words, cur: Parms, prev: Parms):
    """Batched mbe_decodeImbe4400Parms (imbe7200x4400.c:589-630).

    Args: words — the field-forward packed parameter bits (3x [C] int64,
    see pack_imbe_words).
    Returns: (cur', prev', bad [C] int32) — bad lanes (invalid
    fundamental, imbe7200x4400.c:117-130) leave all state untouched.
    """
    dev = words[0].device
    tb = _decode_consts(dev)
    c = words[0].shape[0]

    b0 = _b0_from_words_7200(words)
    bad = (b0 > 207).to(torch.int32)
    b0s = torch.clamp(b0, 0, 207)
    w0 = lookup(table("imbe_w0_by_b0", dev), b0s)
    L = lookup(table("imbe_L_by_b0", dev), b0s)
    K = lookup(table("imbe_K_by_b0", dev), b0s)
    L9 = (L - 9).long()

    # --- every bit-layout read of the bb[58][12] scatter ------------------
    # slot s contributes bit slot_t[s] of column slot_col[s], read from the
    # per-L9 packed position; the column sums are exact integer adds
    pos = tb["slot_pos"][:, L9]                               # [S, C]
    wstack = torch.stack(words)                               # [3, C]
    bit = (torch.gather(wstack, 0, pos >> 5) >> (pos & 31)) & 1
    vals = torch.zeros((_NCOLS, c), dtype=torch.int64, device=dev)
    vals.index_add_(0, tb["slot_col"], bit << tb["slot_t"][:, None])

    # --- voicing (imbe7200x4400.c:170-188): Vl[l] = bb[1][K-1-(l-1)/3] ----
    li = torch.arange(57, device=dev)[:, None]
    tl_idx = torch.clamp(K[None, :] - 1 - torch.div(li - 1, 3, rounding_mode="floor"),
                         0, 11)
    vl_bits = torch.gather(vals[:12], 0, tl_idx.long()).to(torch.int32)
    in_band = (li >= 1) & (li <= L[None, :])
    Vl = torch.where(in_band, vl_bits, cur.Vl)

    # --- gains (imbe7200x4400.c:190-209) ----------------------------------
    valsf = vals.to(torch.float32)
    Gm1 = lookup(table("B2", dev), vals[12])
    Gm_rest = tb["gain_step"][:, L9] * ((valsf[13:18] - tb["gain_off"][:, L9])
                                        + 0.5)
    Gm = torch.cat([Gm1[None, :], Gm_rest], dim=0)            # [6, C]

    # --- Ri = 6-pt IDCT (imbe7200x4400.c:211-231) -------------------------
    Ri = tb["RiM_T"] @ Gm                                     # [6, C]

    # --- HOC coefficients (imbe7200x4400.c:233-249) ------------------------
    hoc = tb["hoc_qfac"][:, L9] * ((valsf[18:72] - tb["hoc_off"][:, L9]) + 0.5)
    hoc = torch.where(tb["m_valid"][:, L9], hoc, 0.0).reshape(6, 9, c)
    Cik = torch.cat([Ri.reshape(6, 1, c), hoc], dim=1)       # [6, 10, C]

    # --- Tl block IDCT (imbe7200x4400.c:251-270) ---------------------------
    # block sizes differ by at most one: the first 6 - L%6 blocks have
    # size L//6, the rest one more; ascending-k sum as the reference
    lo = torch.div(L, 6, rounding_mode="floor")
    v = torch.clamp(lo, 0, 10).long()
    Mlo = tb["m_lo"][:, v]                                    # [100, C]
    Mhi = tb["m_hi"][:, v]
    ehi = (torch.arange(6, device=dev)[:, None] >= (6 - (L - 6 * lo))[None, :])
    ehx = ehi[:, None, :]
    Usel = torch.zeros((6, 10, c), dtype=torch.float32, device=dev)
    for k in range(10):
        wk = torch.where(ehx, Mhi[10 * k:10 * k + 10][None], Mlo[10 * k:10 * k + 10][None])
        Usel = Usel + Cik[:, k, :][:, None, :] * wk
    Usel = Usel.reshape(60, c)
    scl = tb["scl"][:, L9]                                    # [57, C]
    Tl = torch.where(scl >= 0, torch.gather(Usel, 0, torch.clamp(scl, min=0)), 0.0)

    # --- spectral amplitude prediction (imbe7200x4400.c:272-354) ----------
    Lf = L.to(torch.float32)
    rho = torch.where(L <= 15, 0.4, torch.where(L <= 24, 0.03 * Lf - 0.05, 0.7))
    Ml_n, log2_n, pM, pLg, cL = spectral.spectral_update(
        L, prev.L, prev.Ml, prev.log2Ml, Tl, weight=rho,
        cur_Ml=cur.Ml, cur_log2Ml=cur.log2Ml)

    ok = bad == 0
    okc = ok[None, :]
    cur_out = dataclasses.replace(
        cur,
        w0=torch.where(ok, w0, cur.w0),
        L=torch.where(ok, cL, cur.L),
        K=torch.where(ok, K, cur.K),
        Vl=torch.where(okc, Vl, cur.Vl),
        Ml=torch.where(okc, Ml_n, cur.Ml),
        log2Ml=torch.where(okc, log2_n, cur.log2Ml))
    prev_out = dataclasses.replace(
        prev,
        Ml=torch.where(okc, pM, prev.Ml),
        log2Ml=torch.where(okc, pLg, prev.log2Ml))
    return cur_out, prev_out, bad


def decode_imbe7200_frame(frame):
    """Batched mbe_decodeImbe7200x4400Frame, hard bits.

    Args: frame [C, 8, 23] int bit planes.
    Returns: (imbe_d [88, C] int32, c0/protected/c4 errors [C] int32,
    words — the field-forward packed parameter bits, 3x [C] int64).
    """
    dev = frame.device
    pow2 = torch.as_tensor(_POW2_23, device=dev)
    w = (frame.to(torch.int64) * pow2).sum(dim=-1).T.to(torch.int32)  # [8, C]
    c0w, c0_errs = ecc.golay2312_hard_packed(w[0])

    # demod PRNG seeded by C0 data bits 22..11 (imbe7200x4400.c:648-656)
    kw = demod.prng_keywords(16 * (c0w >> 11), (23, 23, 23, 15, 15, 15))

    g_out, g_errs = ecc.golay2312_hard_packed(w[1:4] ^ kw[0:3])
    h_out, h_errs = ecc.hamming1511_hard_packed((w[4:7] & 0x7FFF) ^ kw[3:6])
    perrs = (g_errs.sum(dim=0) + h_errs.sum(dim=0)).to(torch.int32)
    c4_errs = h_errs[0]

    words = _words_from_fields_7200(
        (c0w >> 11) & 0xFFF,
        (g_out[0] >> 11) & 0xFFF, (g_out[1] >> 11) & 0xFFF,
        (g_out[2] >> 11) & 0xFFF,
        (h_out[0] >> 4) & 0x7FF, (h_out[1] >> 4) & 0x7FF,
        (h_out[2] >> 4) & 0x7FF,
        w[7] & 0x7F)
    return expand_imbe_d(words), c0_errs, perrs, c4_errs, words


def process_imbe4400(words, total_errors, c0_errors, c4_errors,
                     cur: Parms, prev: Parms, enh: Parms, comfort_rng,
                     lcg_prime):
    """Batched mbe_processImbe4400Dataf (imbe7200x4400.c:780-888) for the
    hard path, where the C0 and C4 counts are always valid.

    Returns: (audio [160, C] f32, cur', prev', enh', comfort_rng',
    lcg_prime', flags dict of [C] bool: repeat, mute).
    """
    # -- prepare (imbe7200x4400.c:780-808) ---------------------------------
    cur = dataclasses.replace(
        cur,
        errorCount4=c4_errors,
        mutingThreshold=torch.full_like(cur.mutingThreshold,
                                        MUTING_THRESHOLD_IMBE),
        errorCountTotal=total_errors,
        errorRate=(0.95 * prev.errorRate
                   + 0.000365 * total_errors.to(torch.float32)))

    cur, prev, bad = decode_imbe4400_parms(words, cur, prev)

    # -- repeat decision (imbe7200x4400.c:810-840) --------------------------
    repeat_threshold = 10.0 + 40.0 * cur.errorRate
    rep = (bad == 1) | ((c0_errors >= 2)
                        & (total_errors.to(torch.float32) >= repeat_threshold))

    headroom = rep & (prev.repeatCount > 3)
    use_last = rep & ~headroom
    cur_rep = dataclasses.replace(prev, repeatCount=prev.repeatCount + 1)
    cur = select_cases([(headroom, imbe_headroom_reset(cur)),
                        (use_last, cur_rep)], cur)
    cur = dataclasses.replace(
        cur, repeatCount=torch.where(rep, cur.repeatCount, 0))

    # -- synthesis (imbe7200x4400.c:842-856): always runs -------------------
    muted = (cur.repeatCount >= 4) | (cur.errorRate > cur.mutingThreshold)
    prev = cur
    Ml_e, rm0 = spectral_amp_enhance(cur.w0, cur.L, cur.Ml)
    cur = dataclasses.replace(cur, Ml=Ml_e)
    cn, new_rng = noise.comfort_noise(comfort_rng)
    audio, cur, enh, aux = synthesize_speech_core(cur, enh, cn, lcg_prime, rm0)
    comfort_rng = torch.where(aux["mute"][None, :], new_rng, comfort_rng)
    lcg_prime = torch.where(aux["cold_consumed"], noise.LCG_DEFAULT_SEED,
                            lcg_prime)
    return (audio, cur, prev, cur, comfort_rng, lcg_prime,
            dict(repeat=rep, mute=muted))
