"""AMBE+2 3600x2450 (DMR, NXDN, P25 Phase 2, dPMR) and AMBE 3600x2400
(D-STAR), batched over channels (port of mbe_tpu.models.ambe).

The common frame stage (C0 Golay, demodulation, 49-bit packing,
ambe_common.c), both parameter decoders and both process FSMs
(ambe3600x2450.c, ambe3600x2400.c). Table lookups are gathers: the
rows of a table are indexed by the code, and the per-block IDCT matrix by
the block size. Every frame-type branch is computed for all lanes and
committed with lane-wise selects.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..ops import demod, ecc, noise, synth
from ..ops.bits import field, lookup, pack_descending, powers_of_two
from ..ops.cuda import marks
from ..ops.enhance import spectral_amp_enhance
from ..tables import T, table
from . import spectral
from .speech import current_frame_rm0, synthesize_speech_core
from .state import (MUTING_THRESHOLD_AMBE, Parms, default_leaves, erasure_parms, select,
                    select_cases, select_many)

_RCONST = float(np.float32(1.0 / (2.0 * np.sqrt(2.0))))
_UNVC = float(np.float32(0.2046))
_RATE_COEFF = float(np.float32(0.001064))


# ---------------------------------------------------------------------------
# Common frame stage: C0 ECC + demod + 49-bit packing (ambe_common.c:22-189)
# ---------------------------------------------------------------------------

def _extract_bits(word, hi, lo):
    """[hi-lo+1, C] bits of a packed word [C], MSB (bit `hi`) first."""
    shifts = torch.arange(hi, lo - 1, -1, device=word.device)[:, None]
    return (word[None, :] >> shifts) & 1


def golay24_parity_fix(bit0, data_ones, errs):
    """Golay24 even-parity fix of fr[0][0] (ambe_common.c:22-60): a clean
    23-bit Golay decode with odd overall parity flips bit0 and counts one
    error. Returns (bit0', errs')."""
    fix = (errs == 0) & (((bit0 + data_ones) & 1) != 0)
    return torch.where(fix, bit0 ^ 1, bit0), torch.where(fix, 1, errs)


def decode_ambe3600_frame(frame, soft_rel=None):
    """Batched mbe_decodeAmbe3600x24xxFrame common stage.

    Args: frame [C, 4, 24] int bit planes (hard bits, or the hard decisions
    of soft input); soft_rel [C, 4, 24] int reliabilities 0..255, or None
    for the hard path.
    Returns: (ambe_d [49, C] int32, c0_errors [C] int32, protected_errors
    [C] int32). The hard path decodes packed words; the soft one bit planes
    through two launches of the soft decoder, C0 first (its data seeds the
    demodulation of C1).
    """
    if soft_rel is not None:
        return _decode_ambe3600_frame_soft(frame.to(torch.int32), soft_rel.to(torch.int32))
    w = (frame.to(torch.int64) * powers_of_two(24, frame.device)).sum(dim=-1)
    w = w.T.to(torch.int32)  # [4, C]

    # C0: Golay over fr[0][1..23]; Golay24 even-parity fix of fr[0][0]
    g_out, c0_errs = ecc.golay2312_hard_packed((w[0] >> 1) & 0x7FFFFF)
    bit0, c0_errs = golay24_parity_fix(w[0] & 1, ecc.popcount32(g_out), c0_errs)
    fr0 = (g_out << 1) | bit0

    # demod C1 with the keystream seeded by C0 bits 23..12 (ambe_common.c:75-100)
    kw = demod.prng_keywords(16 * ((fr0 >> 12) & 0xFFF), (23,))[0]
    g1_out, perrs = ecc.golay2312_hard_packed((w[1] & 0x7FFFFF) ^ kw)

    # data ECC + 49-bit packing (ambe_common.c:127-157)
    ambe_d = torch.cat([_extract_bits(fr0, 23, 12),      # C0 bits 23..12
                        _extract_bits(g1_out, 22, 11),   # C1 data bits 22..11
                        _extract_bits(w[2], 10, 0),      # C2 bits 10..0
                        _extract_bits(w[3], 13, 0)])     # C3 bits 13..0
    return ambe_d.to(torch.int32), c0_errs, perrs


def _decode_ambe3600_frame_soft(f, soft_rel):
    """Soft-decision frame stage on bit planes, channel-major."""
    g_out, c0_errs = ecc.golay2312_soft(f[:, 0, 1:24], soft_rel[:, 0, 1:24])
    bit0, c0_errs = golay24_parity_fix(f[:, 0, 0], g_out.sum(dim=-1), c0_errs)
    fr0 = torch.cat([bit0[:, None], g_out], dim=-1)  # [C, 24]

    # the keystream is applied to fr[1] bits 22..0 in turn (ambe_common.c:75-100);
    # demodulation flips hard decisions and keeps the reliabilities
    pr = demod.prng_bits(16 * pack_descending(fr0, 23, 12), 23).T.to(torch.int32)
    g1_out, perrs = ecc.golay2312_soft(f[:, 1, :23] ^ pr.flip(-1), soft_rel[:, 1, :23])

    ambe_d = torch.cat([fr0[:, 12:24].flip(-1),        # C0 bits 23..12
                        g1_out[:, 11:23].flip(-1),     # C1 data bits 22..11
                        f[:, 2, :11].flip(-1),         # C2 bits 10..0
                        f[:, 3, :14].flip(-1)], dim=-1)  # C3 bits 13..0
    return ambe_d.T.contiguous(), c0_errs, perrs


# ---------------------------------------------------------------------------
# PRBA / HOC -> Tl (ambe3600x2450.c:221-387, ambe3600x2400.c:266-425)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=2)
def _tl_factored(plus: bool):
    """The factored per-block IDCT (ambe3600x2450.c:365-387 /
    ambe3600x2400.c:403-425, with the k > 6 zero rule folded in):

      M[k-1, off(ji) + (j-1)] = ak * idct[ji][j][k]   (k <= min(ji, 6))
      off(ji) = ji*(ji-1)/2 (ji = 1..17), lmprbl[L, i] the block sizes,
      scl[L, l] = i(l)*17 + (j(l)-1), the slot of band l (-1: none).

    Returns (M [6, 153] f32, off [18] i32, lmprbl [57, 4] i32, scl [57, 57]
    i64)."""
    lmprbl = np.asarray(T.AmbePlusLmprbl if plus else T.AmbeLmprbl, np.int32)
    idct = np.asarray(T.ambe_idct_cos)
    off = np.zeros(18, np.int32)
    for ji in range(1, 18):
        off[ji] = off[ji - 1] + (ji - 1)
    M = np.zeros((6, int(off[17] + 17)), np.float32)
    for ji in range(1, 18):
        for j in range(1, ji + 1):
            for k in range(1, min(ji, 6) + 1):
                M[k - 1, off[ji] + (j - 1)] = (1.0 if k == 1 else 2.0) * idct[ji, j, k]
    scl = np.full((57, 57), -1, np.int64)
    for L in range(57):
        l = 1
        for i in range(4):
            for j in range(1, lmprbl[L, i] + 1):
                scl[L, l] = i * 17 + (j - 1)
                l += 1
    return M, off, lmprbl, scl


@lru_cache(maxsize=1)
def _ri_matrix():
    """Ri[i] = sum_m am * Gm[m] * ri_cos[m][i], m, i in 1..8 -> [8, 8]."""
    ri_cos = np.asarray(T.ambe_ri_cos)
    M = np.zeros((8, 8), np.float32)
    for m in range(1, 9):
        for i in range(1, 9):
            M[m - 1, i - 1] = (1.0 if m == 1 else 2.0) * ri_cos[m, i]
    return M


_HOC = {False: ("AmbeHOCb5", "AmbeHOCb6", "AmbeHOCb7", "AmbeHOCb8"),
        True: ("AmbePlusHOCb5", "AmbePlusHOCb6", "AmbePlusHOCb7", "AmbePlusHOCb8")}


@lru_cache(maxsize=None)
def _tl_consts(plus: bool, device):
    """Device tables of _tl_from_codes, each gathered by column: the
    size-indexed IDCT matrices Mz [102, 18] (column v holds block size v's
    [6, 17] matrix, zero-padded; column 0 is zero, for L = 0 lanes), the
    block sizes [4, 57] and band slots [57, 57] by L, the HOC tables
    [4, rows], and Ri's matrix transposed."""
    M, off, lmprbl, scl = _tl_factored(plus)
    Mz = np.zeros((18, 6, 17), np.float32)
    for v in range(1, 18):
        Mz[v, :, :v] = M[:, off[v]:off[v] + v]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(MzT=dev(Mz.reshape(18, 102).T), lmprbl=dev(lmprbl.T.astype(np.int64)),
                scl=dev(scl.T), RiM_T=dev(_ri_matrix().T),
                hoc=tuple(dev(np.asarray(getattr(T, n), np.float32).T) for n in _HOC[plus]))


def _tl_from_codes(L, Gm, b5, b6, b7, b8, plus: bool):
    """Ri IDCT, Cik assembly and the per-block IDCT, batched.

    Gm [8, C] (Gm[0] = 0), L [C], HOC codes b5..b8 [C]. Returns Tl [57, C].
    Each block's matrix is gathered by its actual size and the k terms
    accumulate in ascending order as the reference's inner loop does."""
    tb = _tl_consts(plus, Gm.device)
    c = Gm.shape[1]
    Ri = tb["RiM_T"] @ Gm                                       # [8, C]
    ra, rb = Ri[0::2], Ri[1::2]                                 # Ri[1,3,5,7], Ri[2,4,6,8]
    hoc = torch.stack([t[:, b.long()] for t, b in zip(tb["hoc"], (b5, b6, b7, b8))])
    cik = torch.cat([(0.5 * (ra + rb))[:, None], (_RCONST * (ra - rb))[:, None], hoc],
                    dim=1)                                      # [4, 6, C]

    Ls = torch.clamp(L, 0, 56).long()
    jsel = tb["lmprbl"][:, Ls]                                  # [4, C] block sizes
    rows = []
    for i in range(4):
        Mi = tb["MzT"][:, jsel[i]].reshape(6, 17, c)
        acc = cik[i, 0][None, :] * Mi[0]
        for k in range(1, 6):
            acc = acc + cik[i, k][None, :] * Mi[k]
        rows.append(acc)
    slots = torch.cat(rows)                                     # [68, C]
    scl = tb["scl"][:, Ls]                                      # [57, C]
    return torch.where(scl >= 0, torch.gather(slots, 0, torch.clamp(scl, min=0)), 0.0)


@lru_cache(maxsize=None)
def _parm_consts(plus: bool, device):
    """The b0-indexed tables (f0, w0, L) and the code tables gathered by
    column (V/UV [8, rows], PRBA24 [3, 512], PRBA58 [4, 128]) and the gain
    steps of one codec on `device`."""
    def dev(name, dtype):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(getattr(T, name), dtype)),
                               device=device)

    if plus:
        return dict(f0=dev("ambe2400_f0_by_b0", np.float32), w0=dev("ambe2400_w0_by_b0", np.float32),
                    L=dev("AmbePlusLtable", np.int32), dg=dev("AmbePlusDg", np.float32),
                    vuv=dev("AmbePlusVuv", np.int32).T.contiguous(),
                    prba24=dev("AmbePlusPRBA24", np.float32).T.contiguous(),
                    prba58=dev("AmbePlusPRBA58", np.float32).T.contiguous())
    return dict(f0=dev("AmbeW0table", np.float32), w0=dev("ambe2450_w0_by_b0", np.float32),
                L=dev("AmbeLtable", np.int32), dg=dev("AmbeDg", np.float32),
                vuv=dev("AmbeVuv", np.int32).T.contiguous(),
                prba24=dev("AmbePRBA24", np.float32).T.contiguous(),
                prba58=dev("AmbePRBA58", np.float32).T.contiguous())


def _spectral_commit(tb, plus, L, f0, w0, b1, gamma, Gm, hoc, silence, cur, prev):
    """The V/UV bands, Tl and the spectral prediction shared by both
    parameter decoders; bands 1..L of `silence` lanes are unvoiced. Lanes
    that are neither voice nor silence are computed too and never
    committed. Returns (Vl, Ml, log2Ml, prev Ml, prev log2Ml, clamped L)."""
    li = torch.arange(57, device=L.device)[:, None]
    jl = torch.clamp((li.to(torch.float32) * 16.0 * f0[None, :]).to(torch.int64), 0, 7)
    v_tab = torch.gather(tb["vuv"][:, b1.long()], 0, jl)  # V/UV row b1, entry jl[l]
    in_band = (li >= 1) & (li <= L[None, :])
    Vl = torch.where(in_band & silence[None, :], 0, torch.where(in_band, v_tab, cur.Vl))
    Tl = _tl_from_codes(L, Gm, *hoc, plus=plus)
    unvc = torch.full_like(w0, _UNVC) / torch.sqrt(w0)
    return (Vl, *spectral.spectral_update(
        L, prev.L, prev.Ml, prev.log2Ml, Tl, weight=torch.full_like(gamma, 0.65),
        cur_Ml=cur.Ml, cur_log2Ml=cur.log2Ml, gamma=gamma, unvc=unvc, Vl=Vl))


def _gm(gamma, tb, b3, b4):
    """Gm [8, C]: 0, then PRBA24 row b3 and PRBA58 row b4."""
    return torch.cat([torch.zeros_like(gamma)[None, :], tb["prba24"][:, b3.long()],
                      tb["prba58"][:, b4.long()]])


# ---------------------------------------------------------------------------
# AMBE+2 3600x2450 decode (ambe3600x2450.c:176-621)
# ---------------------------------------------------------------------------

def tone_verified_2450(ambe_d):
    """JMBE tone classification checks (ambe3600x2450.c:474-491).
    ambe_d [49, C]. Returns three [C] bool: u0 high bits all ones, u3 low
    nibble zero, u1 nibbles equal."""
    d = ambe_d.to(torch.int32)
    u0 = field(d, range(0, 12))
    u1 = field(d, range(12, 24))
    u3 = field(d, range(35, 49))
    return ((u0 >> 6) & 0x3F) == 63, (u3 & 0xF) == 0, ((u1 >> 8) & 0xF) == (u1 & 0xF)


def tone_id_2450(ambe_d):
    """ID1 = ambe_d bits 12..19, MSB first (ambe3600x2450.c:80-89)."""
    return field(ambe_d.to(torch.int32), range(12, 20))


def decode_ambe2450_parms(ambe_d, cur: Parms, prev: Parms, total_errors):
    """Batched mbe_decodeAmbe2450ParmsInternal (ambe3600x2450.c:564-621).

    total_errors [C] i32; a negative count disables the tone BER gate.
    Returns (cur', prev', bad [C] i32: 0 voice or silence, 2 erasure,
    7 tone).
    """
    d = ambe_d.to(torch.int32)
    tb = _parm_consts(False, d.device)

    t0, t3, t1 = tone_verified_2450(d)
    tone = t0 & (t3 | t1) & ((total_errors < 6) | (total_errors < 0))
    b0 = field(d, (0, 1, 2, 3, 37, 38, 39))
    sil = ~tone & ((b0 == 124) | (b0 == 125))
    era = ~tone & ~sil & (b0 >= 120)
    voice = ~tone & ~sil & ~era
    bad = torch.where(tone, 7, torch.where(era, 2, 0)).to(torch.int32)

    sil_f0, sil_w0 = (float(x) for x in T.ambe2450_silence_f0_w0)
    f0 = torch.where(sil, sil_f0, lookup(tb["f0"], b0))
    w0 = torch.where(sil, sil_w0, lookup(tb["w0"], b0))
    L = torch.where(sil, torch.where(b0 == 124, 15, 14),
                    lookup(tb["L"], b0)).to(torch.int32)

    # gain (ambe3600x2450.c:598-607), PRBA (:221-273), HOC
    gamma = lookup(tb["dg"], field(d, (8, 9, 10, 11, 36))) + 0.5 * prev.gamma
    Gm = _gm(gamma, tb, field(d, (12, 13, 14, 15, 16, 17, 18, 19, 40)),
             field(d, (20, 21, 22, 23, 41, 42, 43)))
    hoc = (field(d, (24, 25, 26, 27, 44)), field(d, (28, 29, 30, 45)),
           field(d, (31, 32, 33, 46)), field(d, (34, 47, 48)))
    # V/UV (ambe3600x2450.c:197-219); silence zeroes Vl[1..L] instead
    Vl, Ml_n, log2_n, pM, pLg, cL = _spectral_commit(
        tb, False, L, f0, w0, field(d, (4, 5, 6, 7, 35)), gamma, Gm, hoc, sil, cur, prev)

    ok = voice | sil
    okc = ok[None, :]
    cur_out = dataclasses.replace(
        cur, w0=torch.where(ok, w0, cur.w0), L=torch.where(ok, cL, cur.L),
        Vl=torch.where(okc, Vl, cur.Vl), gamma=torch.where(ok, gamma, cur.gamma),
        Ml=torch.where(okc, Ml_n, cur.Ml), log2Ml=torch.where(okc, log2_n, cur.log2Ml))
    prev_out = dataclasses.replace(
        prev, Ml=torch.where(okc, pM, prev.Ml), log2Ml=torch.where(okc, pLg, prev.log2Ml))
    return cur_out, prev_out, bad


# ---------------------------------------------------------------------------
# AMBE 3600x2400 decode (ambe3600x2400.c:164-546)
# ---------------------------------------------------------------------------

def decode_ambe2400_parms(ambe_d, cur: Parms, prev: Parms):
    """Batched mbe_decodeAmbe2400Parms.

    Returns (cur', prev', bad [C] i32: 0 voice, 3 tone or silence
    classification, 5..122 the D-STAR tone index).
    """
    d = ambe_d.to(torch.int32)
    tb = _parm_consts(True, d.device)

    b0 = field(d, (0, 1, 2, 3, 4, 5, 48))
    tone_b0 = (b0 & 0x7E) == 0x7E
    tone_index = synth.dstar_tone_id(d)
    single_tone = tone_b0 & (tone_index >= 5) & (tone_index <= 122)
    dual_range = tone_b0 & (tone_index >= 128) & (tone_index <= 163)
    silence = tone_b0 & ~single_tone & ~dual_range
    bad = torch.where(single_tone, tone_index, torch.where(tone_b0, 3, 0)).to(torch.int32)
    voice = ~tone_b0

    f0 = lookup(tb["f0"], b0)
    w0 = torch.where(silence, float(T.ambe2400_silence_w0[0]), lookup(tb["w0"], b0))
    L = torch.where(silence, 14, lookup(tb["L"], b0)).to(torch.int32)

    gamma = lookup(tb["dg"], field(d, (6, 7, 8, 9, 42, 43))) + 0.5 * prev.gamma
    Gm = _gm(gamma, tb, field(d, (10, 11, 12, 13, 14, 15, 16, 44, 45)),
             field(d, (17, 18, 19, 20, 21, 46, 47)))
    hoc = (field(d, (22, 23, 25, 26)), field(d, (27, 28, 29, 30)),
           field(d, (31, 32, 33, 34)), field(d, (35, 36, 37)) << 1)
    # V/UV (ambe3600x2400.c:244-263); silence zeroes Vl[1..14]
    Vl, Ml_n, log2_n, pM, pLg, cL = _spectral_commit(
        tb, True, L, f0, w0, field(d, (38, 39, 40, 41)), gamma, Gm, hoc, silence, cur, prev)

    # silence writes only w0, L and Vl (ambe3600x2400.c:202-210); voice all
    model = voice | silence
    vc = voice[None, :]
    cur_out = dataclasses.replace(
        cur, w0=torch.where(model, w0, cur.w0),
        L=torch.where(model, torch.where(voice, cL, L), cur.L),
        Vl=torch.where(model[None, :], Vl, cur.Vl), gamma=torch.where(voice, gamma, cur.gamma),
        Ml=torch.where(vc, Ml_n, cur.Ml), log2Ml=torch.where(vc, log2_n, cur.log2Ml))
    prev_out = dataclasses.replace(
        prev, Ml=torch.where(vc, pM, prev.Ml), log2Ml=torch.where(vc, pLg, prev.log2Ml))
    return cur_out, prev_out, bad


# ---------------------------------------------------------------------------
# Process FSMs
# ---------------------------------------------------------------------------

def _ambe_prepare(total_errors, cur: Parms, prev: Parms, enh: Parms):
    """Common prepare: AMBE defaults on lanes not yet in AMBE mode, and the
    error-rate IIR (ambe3600x2450.c:716-747 / ambe3600x2400.c:629-659)."""
    need_init = torch.abs(prev.mutingThreshold - MUTING_THRESHOLD_AMBE) > 1e-6
    defaults = default_leaves(ambe=True)
    cur, prev, enh = select_many([([(need_init, defaults)], p) for p in (cur, prev, enh)])
    cur = dataclasses.replace(
        cur, mutingThreshold=torch.full_like(cur.mutingThreshold, MUTING_THRESHOLD_AMBE),
        errorCountTotal=total_errors, errorCount4=torch.zeros_like(cur.errorCount4),
        errorRate=0.95 * prev.errorRate + _RATE_COEFF * total_errors.to(torch.float32))
    return cur, prev, enh


def _speech_paths(cur: Parms, enh: Parms, voice_ok, tone_replay, comfort_samples, lcg_prime):
    """One speech-core run for both the voice path (enhance cur, synthesize
    against enh) and the invalid-tone replay path (synthesize enh against
    enh; ambe3600x2450.c:801-820).

    Returns (audio, synthesized cur, prev_raw, aux); prev_raw is cur before
    the enhancement (the C moves cur into prev first, ambe3600x2450.c:789)."""
    Ml_e, rm0_v = spectral_amp_enhance(cur.w0, cur.L, cur.Ml)
    synth_cur = select(tone_replay, enh, dataclasses.replace(cur, Ml=Ml_e))
    rm0 = torch.where(tone_replay, current_frame_rm0(enh), torch.where(voice_ok, rm0_v, 0.0))
    audio, synth_out, _, aux = synthesize_speech_core(synth_cur, enh, comfort_samples,
                                                      lcg_prime, rm0)
    return audio, synth_out, cur, aux


def _tone_render(tones_enabled, tone_id, amplitude_id, cur: Parms, like):
    """render_tone, or silence with the tone state kept when tones are
    disabled (DISABLE_AMBE_TONES, mbelib.c:747-751)."""
    if tones_enabled:
        return synth.render_tone(tone_id, amplitude_id, cur.swn, cur.tonePhase)
    return torch.zeros_like(like), cur.swn, cur.tonePhase


def process_ambe2450(ambe_d, total_errors, c0_errors, c0_valid, cur: Parms, prev: Parms,
                     enh: Parms, comfort_rng, lcg_prime, tones_enabled: bool = True):
    """Batched mbe_processAmbe2450Dataf (ambe3600x2450.c:851-877).

    c0_valid [C] bool: whether c0_errors is known (the frame path) or not
    (the data path). Returns (audio [160, C], cur', prev', enh',
    comfort_rng', lcg_prime', flags dict of [C] bool: erasure, tone,
    repeat, mute).
    """
    marks.mark("fsm", ambe_d)
    cur, prev, enh = _ambe_prepare(total_errors, cur, prev, enh)
    c0e = torch.where(c0_valid, c0_errors, 0)
    cur, prev, bad = decode_ambe2450_parms(ambe_d, cur, prev, total_errors)

    # -- update_decode_state (ambe3600x2450.c:760-783) ----------------------
    is_era = bad == 2
    is_tone = bad == 7
    rep = (bad == 0) & torch.where(c0_valid, (c0e >= 4) | ((c0e >= 2) & (total_errors >= 6)),
                                   total_errors > 3)
    cur_z = dataclasses.replace(cur, repeatCount=torch.zeros_like(cur.repeatCount))
    cur_rep = dataclasses.replace(prev, repeatCount=prev.repeatCount + 1)
    cur = select_cases([(is_era, erasure_parms(cur_z, prev)), (is_tone, cur_z),
                        (rep, cur_rep)], cur_z)

    # -- synthesize_frame (ambe3600x2450.c:831-849) --------------------------
    voice = bad == 0
    voice_ok = voice & (cur.repeatCount < 4)
    voice_mute = voice & ~voice_ok
    tone_valid = lookup(table("tone_valid", ambe_d.device), tone_id_2450(ambe_d)) != 0
    tone_play = is_tone & tone_valid
    tone_replay = is_tone & ~tone_valid & (prev.repeatCount < 4)
    tone_cn = is_tone & ~tone_valid & ~tone_replay

    marks.mark("synthesis", ambe_d)
    cn, new_rng = noise.comfort_noise(comfort_rng)
    audio_s, synth_out, prev_raw, aux = _speech_paths(cur, enh, voice_ok, tone_replay, cn,
                                                      lcg_prime)
    ad, id1 = synth.parse_tone_fields(ambe_d)
    tone_audio, swn2, tp2 = _tone_render(tones_enabled, id1, ad, cur, cn)

    cn_lanes = voice_mute | tone_cn | is_era
    do_speech = voice_ok | tone_replay
    audio = torch.where(do_speech[None, :], audio_s,
                        torch.where(tone_play[None, :], tone_audio,
                                    torch.where(cn_lanes[None, :], cn, 0.0)))
    comfort_rng = torch.where(((do_speech & aux["mute"]) | cn_lanes)[None, :], new_rng,
                              comfort_rng)
    lcg_prime = torch.where(do_speech & aux["cold_consumed"], noise.LCG_DEFAULT_SEED, lcg_prime)

    # -- state commits -------------------------------------------------------
    marks.mark("fsm", ambe_d)
    defaults = default_leaves(ambe=True)
    reinit = voice_mute | tone_cn
    cur_tone = dataclasses.replace(cur, swn=swn2, tonePhase=tp2)
    # one select for the three: case source 0 is the new cur (output 0)
    new_cur, prev, enh = select_many([
        ([(voice_ok, synth_out), (tone_play, cur_tone), (reinit, defaults)], cur),
        ([(voice_ok, prev_raw), (is_era, 0), (reinit, defaults)], prev),
        ([(do_speech, synth_out), (is_era, 0), (reinit, defaults)], enh)])
    flags = dict(erasure=is_era, tone=is_tone, repeat=rep, mute=voice_mute)
    return audio, new_cur, prev, enh, comfort_rng, lcg_prime, flags


def process_ambe2400(ambe_d, total_errors, c0_errors, c0_valid, cur: Parms, prev: Parms,
                     enh: Parms, comfort_rng, lcg_prime, tones_enabled: bool = True):
    """Batched mbe_processAmbe2400Dataf (ambe3600x2400.c:732-762). Arguments
    and returns as process_ambe2450; the erasure flag is never set."""
    marks.mark("fsm", ambe_d)
    cur, prev, enh = _ambe_prepare(total_errors, cur, prev, enh)
    c0e = torch.where(c0_valid, c0_errors, 0)
    cur, prev, bad = decode_ambe2400_parms(ambe_d, cur, prev)

    # -- update_decode_state (ambe3600x2400.c:661-686) -----------------------
    is_tone3 = bad == 3
    dstar_tone = (bad >= 7) & (bad <= 122) & (c0e < 2) & (total_errors < 3)
    rep = ~(is_tone3 | dstar_tone) & (total_errors > 3)
    cur_z = dataclasses.replace(cur, repeatCount=torch.zeros_like(cur.repeatCount))
    cur_rep = dataclasses.replace(prev, repeatCount=prev.repeatCount + 1)
    cur = select_cases([(is_tone3, cur_z), (dstar_tone, cur), (rep, cur_rep)], cur_z)

    # -- synthesize_frame (ambe3600x2400.c:711-730) ---------------------------
    voice = bad == 0
    voice_ok = voice & (cur.repeatCount < 4)
    voice_mute = voice & ~voice_ok

    marks.mark("synthesis", ambe_d)
    cn, new_rng = noise.comfort_noise(comfort_rng)
    audio_s, synth_out, prev_raw, aux = _speech_paths(
        cur, enh, voice_ok, torch.zeros_like(voice_ok), cn, lcg_prime)
    # D-STAR tone: fixed amplitude 103, single tone by index (mbelib.c:813-856)
    tone_audio, swn2, tp2 = _tone_render(tones_enabled, torch.clamp(bad, 0, 255),
                                         torch.full_like(bad, 103), cur, cn)

    cn_lanes = voice_mute | (~voice & ~dstar_tone)  # bad 3, 5/6, noisy tones
    audio = torch.where(voice_ok[None, :], audio_s,
                        torch.where(dstar_tone[None, :], tone_audio,
                                    torch.where(cn_lanes[None, :], cn, 0.0)))
    comfort_rng = torch.where(((voice_ok & aux["mute"]) | cn_lanes)[None, :], new_rng,
                              comfort_rng)
    lcg_prime = torch.where(voice_ok & aux["cold_consumed"], noise.LCG_DEFAULT_SEED, lcg_prime)

    marks.mark("fsm", ambe_d)
    defaults = default_leaves(ambe=True)
    cur_tone = dataclasses.replace(cur, swn=swn2, tonePhase=tp2)
    # one select for the three: case source 0 is the new cur (output 0)
    new_cur, prev, enh = select_many([
        ([(voice_ok, synth_out), (dstar_tone, cur_tone), (cn_lanes, defaults)], cur),
        ([(voice_ok, prev_raw), (dstar_tone, 0), (cn_lanes, defaults)], prev),
        ([(voice_ok, synth_out), (cn_lanes, defaults)], enh)])
    flags = dict(erasure=torch.zeros_like(voice), tone=is_tone3, repeat=rep, mute=voice_mute)
    return audio, new_cur, prev, enh, comfort_rng, lcg_prime, flags
