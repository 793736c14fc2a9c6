"""Speech and tone synthesis: phases, the voiced oscillator bank, unvoiced
FFT + WOLA, tones, clipping (port of mbe_tpu.ops.synth; mbelib.c:691-1105,
mbe_unvoiced_fft.c:714-761).

Band arrays are [57, C], buffers [256, C], audio [160, C]. On the GPU the
voiced bank runs in the hand-written kernel of ops/cuda/voiced.py, the
unvoiced stage in that of ops/cuda/unvoiced.py and the tone in that of
ops/cuda/sources.py; CPU tensors take their plain forms.
"""

from functools import lru_cache

import numpy as np
import torch

from ..tables import T, table
from .bits import field, lookup
from .cuda import sources, unvoiced, voiced

FRAME = 160
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
WHITE_NOISE_SCALAR = float(np.float32(2.0 * np.pi / 53125.0))
SOFT_CLIP = float(np.float32((32767.0 * 0.95) / 7.0))
MAX_SHORT = float(np.float32(32767.0 * 0.95))
TONE_RAD = float(np.float32(2.0 * np.pi / 4294967296.0))  # radians per uint32 phase step
HALF_PI = float(np.float32(np.pi / 2.0))


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
    theta_n = phi0 + alpha*n + q*n^2: the kernel for CUDA tensors, the
    plain form for CPU tensors."""
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
    sums = voiced.voiced_sums_reference if cur_w0.device.type == "cpu" else voiced.voiced_sums
    return sums(
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

def unvoiced_fft(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer):
    """JMBE #117-126. Returns (unvoiced_add [160, C], new_previousUw
    [128, C]); band inputs [57, C], noise_buffer [256, C]. The whole stage
    is ops/cuda/unvoiced.unvoiced_wola, the hand-written kernel, for CUDA
    tensors, and its plain form for CPU tensors."""
    if cur_w0.device.type == "cpu":
        return unvoiced.unvoiced_wola_reference(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw,
                                                noise_buffer)
    return unvoiced.unvoiced_wola(cur_w0, cur_L, cur_Ml, cur_Vl, previous_uw, noise_buffer)


# ---------------------------------------------------------------------------
# Tone synthesis (mbelib.c:691-856)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _tone_tables(device):
    """Per-tone-id (step1, step2, active, dual) [256] on `device`.

    The uint32 phase steps (mbelib.c:692-699) are computed in float64 as
    the C double arithmetic, held as int64; step1 is 0 unless the tone is
    active (valid and freq1 > 0), step2 0 unless it is also dual (freq2 >
    0 and distinct from freq1)."""
    f32 = np.asarray(T.tone_freqs, np.float32)  # [256, 2]
    steps = (f32.astype(np.float64) / 8000.0) * 4294967296.0
    steps = np.where(steps <= 0.0, 0.0, steps + 0.5).astype(np.uint64) & 0xFFFFFFFF
    active = (np.asarray(T.tone_valid) != 0) & (f32[:, 0] > 0.0)
    dual = active & (f32[:, 1] > 0.0) & (np.abs(f32[:, 1] - f32[:, 0]) > np.float32(1e-6))
    step1 = np.where(active, steps[:, 0], 0).astype(np.int64)
    step2 = np.where(dual, steps[:, 1], 0).astype(np.int64)
    return tuple(torch.as_tensor(a, device=device) for a in (step1, step2, active, dual))


def parse_tone_fields(ambe_d):
    """AD / ID1 extraction from 49 AMBE bits (mbelib.c:760-789).

    ambe_d: [49, C] (channel-minor). Returns (AD [C] i32, ID1 [C] i32)."""
    d = ambe_d.to(torch.int32)
    u0, u1, u3 = field(d, range(0, 12)), field(d, range(12, 24)), field(d, range(35, 49))
    return ((u0 & 0x3F) << 1) + ((u3 >> 4) & 1), (u1 & 0xFFF) >> 4


def render_tone(tone_id, amplitude_id, swn, tone_phase):
    """mbe_renderTonef (mbelib.c:707-736): the plain form below for CPU
    tensors, the kernel of ops/cuda/sources.py (bit for bit the same) for
    CUDA tensors, which take tone_id and amplitude_id as [C] int32.
    Returns (samples [160, C], swn', tonePhase')."""
    if tone_id.device.type == "cpu":
        return render_tone_reference(tone_id, amplitude_id, swn, tone_phase)
    return sources.render_tone(tone_id, amplitude_id, swn, tone_phase,
                               _tone_tables(tone_id.device), SOFT_CLIP, TONE_RAD, HALF_PI)


def render_tone_reference(tone_id, amplitude_id, swn, tone_phase):
    """The plain form of render_tone, batched with exact uint32 phases.

    The phase of sample n is (phase0 + step*(n+1)) mod 2^32 in int64, as
    the reference's accumulator; the steps are gathered by tone id.
    Silence (all-zero output, state unchanged) for invalid tone ids or
    freq1 <= 0. swn / tone_phase are [C] int64 holding uint32 values.
    Returns (samples [160, C], swn', tonePhase').
    """
    step1_t, step2_t, active_t, dual_t = _tone_tables(tone_id.device)
    tid = torch.clamp(tone_id, 0, 255).long()
    step1, step2, active, dual = step1_t[tid], step2_t[tid], active_t[tid], dual_t[tid]
    gain = (torch.clamp(amplitude_id, min=0).to(torch.float32) / 127.0) * SOFT_CLIP

    nn = torch.arange(1, FRAME + 1, device=tone_id.device, dtype=torch.int64)[:, None]

    def osc(phase0, step):
        ph = (phase0[None, :] + step[None, :] * nn) & 0xFFFFFFFF  # [160, C]
        return torch.sin(ph.to(torch.float32) * TONE_RAD - HALF_PI)

    g1 = torch.where(active, torch.where(dual, 0.5 * gain, gain), 0.0)[None, :]
    g2 = torch.where(dual, 0.5 * gain, 0.0)[None, :]
    samples = g1 * osc(swn, step1) + g2 * osc(tone_phase, step2)
    new_swn = torch.where(active, (swn + step1 * FRAME) & 0xFFFFFFFF, swn)
    new_tp = torch.where(dual, (tone_phase + step2 * FRAME) & 0xFFFFFFFF, tone_phase)
    return samples, new_swn, new_tp


def dstar_tone_id(ambe_d):
    """AMBE2400 scrambled tone index (ambe3600x2400.c:177-199).
    ambe_d: [49, C] (channel-minor)."""
    d = ambe_d.to(torch.int32)
    defv = (d[6] << 2) | (d[7] << 1) | d[8]
    t7, t6, t5 = (lookup(table(name, d.device), defv).to(torch.int32)
                  for name in ("dstar_t7tab", "dstar_t6tab", "dstar_t5tab"))
    return ((t7 << 7) | (t6 << 6) | (t5 << 5) | (d[9] << 4)
            | (d[42] << 3) | (d[43] << 2) | (d[10] << 1) | d[11])


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
