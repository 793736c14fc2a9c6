"""Noise and tone sources of the synthesis layer: the hand-written CUDA
kernel (csrc/sources.cu), one launch per entry point.

- comfort_noise: java.util.Random comfort noise [n, C] and the advanced
  16-bit limbs [3, C];
- lcg_buffer: the unvoiced LCG buffer [256, C] (96 overlap samples, then
  160) and the new seed and previous seed [C];
- render_tone: a tone [160, C] and its two uint32 phase accumulators [C].

ops/noise.py (comfort_noise, generate_noise_with_overlap) and ops/synth.py
(render_tone) hold the one dispatch: their plain forms for CPU tensors,
these entry points for CUDA tensors, whose outputs equal the plain forms'
bit for bit; they pass in the jump and tone tables and the gains. Every
tensor argument is checked (dtype, shape, contiguity), and any device but
CUDA raises. A call with no channels launches nothing.
"""

import numpy as np
import torch

from . import build

FRAME = 160
BUFFER = 256

# sample rows per thread, by entry point (the split measured on the card:
# PERF.md, the kernel table)
SPAN = {"comfort_noise": 32, "lcg_buffer": 16, "tone_render": 16}

# the tone gain's division by 127 as PyTorch computes it on a CUDA tensor:
# a product with the float reciprocal
INV_127 = float(np.float32(1.0) / np.float32(127.0))

_P, _I, _F = build.PTR, build.INT, build.FLOAT
ENTRIES = {fn: build.register(build.Kernel("sources", build.CSRC / "sources.cu", f"mbe_{fn}",
                                           argtypes, None))
           for fn, argtypes in (("comfort_noise", [_P] * 3 + [_F, _I, _P, _P, _I, _I, _P]),
                                ("lcg_buffer", [_P] * 8 + [_I, _I, _P]),
                                ("tone_render", [_P] * 8 + [_F] * 4 + [_P] * 3 + [_I, _I, _P]))}


def _launch(fn, device, c, *args):
    """Launch entry point `fn` over c channels with SPAN[fn] rows a thread,
    unless c is 0; off CUDA raise either way."""
    if c > 0:
        ENTRIES[fn].launch(device, *args, c, SPAN[fn])
    else:
        ENTRIES[fn].gate(device)


def comfort_noise(limbs, n, jump_a, jump_b, gain):
    """(samples [n, C] f32, new_limbs [3, C] int64) from limbs [3, C] int64,
    1 <= n <= 160: n steps of java.util.Random, whose state after k + 1
    steps is jump_a[k]*s + jump_b[k] mod 2^48 (jump tables [160] int64),
    each sample ((top 24 bits / 2^24) * 2 - 1) * gain."""
    if not 1 <= n <= FRAME:
        raise ValueError(f"comfort_noise: n must lie in 1..{FRAME}, got {n}")
    c = limbs.shape[-1]
    device = build.check("comfort_noise", [("limbs", limbs, torch.int64, (3, c)),
                                           ("jump_a", jump_a, torch.int64, (FRAME,)),
                                           ("jump_b", jump_b, torch.int64, (FRAME,))])
    samples = torch.empty((n, c), dtype=torch.float32, device=device)
    new_limbs = torch.empty((3, c), dtype=torch.int64, device=device)
    _launch("comfort_noise", device, c, limbs, jump_a, jump_b, gain, n, samples, new_limbs)
    return samples, new_limbs


def lcg_buffer(noise_seed, noise_prev_seed, prime_value, lcg_a, lcg_b):
    """(buffer [256, C] f32, new_seed [C] f32, new_prev_seed [C] f32) from
    three [C] f32 tensors and the LCG's jump tables lcg_a, lcg_b [FRAME + 1,
    1] int64 (state_{n+k} = A[k]*s + B[k] mod 53125)."""
    c = noise_seed.shape[-1]
    device = build.check("lcg_buffer", [("noise_seed", noise_seed, torch.float32, (c,)),
                                        ("noise_prev_seed", noise_prev_seed, torch.float32, (c,)),
                                        ("prime_value", prime_value, torch.float32, (c,)),
                                        ("lcg_a", lcg_a, torch.int64, (FRAME + 1, 1)),
                                        ("lcg_b", lcg_b, torch.int64, (FRAME + 1, 1))])
    buffer = torch.empty((BUFFER, c), dtype=torch.float32, device=device)
    new_seed = torch.empty_like(noise_seed)
    new_prev_seed = torch.empty_like(noise_seed)
    _launch("lcg_buffer", device, c, noise_seed, noise_prev_seed, prime_value, lcg_a, lcg_b,
            buffer, new_seed, new_prev_seed)
    return buffer, new_seed, new_prev_seed


def render_tone(tone_id, amplitude_id, swn, tone_phase, tables, soft_clip, rad, half_pi):
    """(samples [160, C] f32, swn' [C] int64, tonePhase' [C] int64) from
    tone_id, amplitude_id [C] int32 and swn, tone_phase [C] int64 holding
    uint32 values; `tables` is (step1, step2, active, dual) [256] by tone
    id (synth._tone_tables), and sample n of an oscillator is
    sin(phase * rad - half_pi) times the gain amplitude / 127 * soft_clip."""
    c = tone_id.shape[-1]
    step1, step2, active, dual = tables
    device = build.check("render_tone", [("tone_id", tone_id, torch.int32, (c,)),
                                         ("amplitude_id", amplitude_id, torch.int32, (c,)),
                                         ("swn", swn, torch.int64, (c,)),
                                         ("tone_phase", tone_phase, torch.int64, (c,)),
                                         ("step1", step1, torch.int64, (256,)),
                                         ("step2", step2, torch.int64, (256,)),
                                         ("active", active, torch.bool, (256,)),
                                         ("dual", dual, torch.bool, (256,))])
    samples = torch.empty((FRAME, c), dtype=torch.float32, device=device)
    new_swn = torch.empty_like(swn)
    new_tp = torch.empty_like(tone_phase)
    _launch("tone_render", device, c, tone_id, amplitude_id, swn, tone_phase, step1, step2,
            active, dual, soft_clip, INV_127, rad, half_pi, samples, new_swn, new_tp)
    return samples, new_swn, new_tp
