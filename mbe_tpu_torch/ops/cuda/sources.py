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
CUDA raises. The kernel is built with nvcc at first use into build/,
keyed by a hash of its source.
"""

import ctypes

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

SOURCE = build.CSRC / "sources.cu"

# kernel launches made by the three entry points (the plain forms do not count)
LAUNCHES = 0
_LIB = None


def load_library():
    """Build (if needed) and load the kernel library; returns it with the
    argument types of its three C entry points set."""
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mbe_comfort_noise.argtypes = [ptr] * 3 + [f, i, ptr, ptr, i, i, ptr]
        lib.mbe_lcg_buffer.argtypes = [ptr] * 8 + [i, i, ptr]
        lib.mbe_tone_render.argtypes = [ptr] * 8 + [f] * 4 + [ptr] * 3 + [i, i, ptr]
        for fn in (lib.mbe_comfort_noise, lib.mbe_lcg_buffer, lib.mbe_tone_render):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(fn, args):
    """Each (name, tensor, dtype, shape) of `args`: dtype, shape and layout,
    then one CUDA device for all. Returns the device."""
    device = args[0][1].device
    for name, x, dtype, shape in args:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {dtype} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{fn}: {name} is on {x.device}, not {device}")
    if device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {device}")
    return device


def _launch(fn, entry, *args):
    """Call the C entry point on the current stream; count the launch."""
    global LAUNCHES
    device = args[0].device
    c = args[0].shape[-1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                    c, SPAN[fn], stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    if c > 0:
        LAUNCHES += 1


def comfort_noise(limbs, n, jump_a, jump_b, gain):
    """(samples [n, C] f32, new_limbs [3, C] int64) from limbs [3, C] int64,
    1 <= n <= 160: n steps of java.util.Random, whose state after k + 1
    steps is jump_a[k]*s + jump_b[k] mod 2^48 (jump tables [160] int64),
    each sample ((top 24 bits / 2^24) * 2 - 1) * gain."""
    if not 1 <= n <= FRAME:
        raise ValueError(f"comfort_noise: n must lie in 1..{FRAME}, got {n}")
    c = limbs.shape[-1]
    device = _check("comfort_noise", [("limbs", limbs, torch.int64, (3, c)),
                                      ("jump_a", jump_a, torch.int64, (FRAME,)),
                                      ("jump_b", jump_b, torch.int64, (FRAME,))])
    samples = torch.empty((n, c), dtype=torch.float32, device=device)
    new_limbs = torch.empty((3, c), dtype=torch.int64, device=device)
    _launch("comfort_noise", load_library().mbe_comfort_noise, limbs, jump_a, jump_b, gain, n,
            samples, new_limbs)
    return samples, new_limbs


def lcg_buffer(noise_seed, noise_prev_seed, prime_value, lcg_a, lcg_b):
    """(buffer [256, C] f32, new_seed [C] f32, new_prev_seed [C] f32) from
    three [C] f32 tensors and the LCG's jump tables lcg_a, lcg_b [FRAME + 1,
    1] int64 (state_{n+k} = A[k]*s + B[k] mod 53125)."""
    c = noise_seed.shape[-1]
    device = _check("lcg_buffer", [("noise_seed", noise_seed, torch.float32, (c,)),
                                   ("noise_prev_seed", noise_prev_seed, torch.float32, (c,)),
                                   ("prime_value", prime_value, torch.float32, (c,)),
                                   ("lcg_a", lcg_a, torch.int64, (FRAME + 1, 1)),
                                   ("lcg_b", lcg_b, torch.int64, (FRAME + 1, 1))])
    buffer = torch.empty((BUFFER, c), dtype=torch.float32, device=device)
    new_seed = torch.empty_like(noise_seed)
    new_prev_seed = torch.empty_like(noise_seed)
    _launch("lcg_buffer", load_library().mbe_lcg_buffer, noise_seed, noise_prev_seed,
            prime_value, lcg_a, lcg_b, buffer, new_seed, new_prev_seed)
    return buffer, new_seed, new_prev_seed


def render_tone(tone_id, amplitude_id, swn, tone_phase, tables, soft_clip, rad, half_pi):
    """(samples [160, C] f32, swn' [C] int64, tonePhase' [C] int64) from
    tone_id, amplitude_id [C] int32 and swn, tone_phase [C] int64 holding
    uint32 values; `tables` is (step1, step2, active, dual) [256] by tone
    id (synth._tone_tables), and sample n of an oscillator is
    sin(phase * rad - half_pi) times the gain amplitude / 127 * soft_clip."""
    c = tone_id.shape[-1]
    step1, step2, active, dual = tables
    device = _check("render_tone", [("tone_id", tone_id, torch.int32, (c,)),
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
    _launch("tone_render", load_library().mbe_tone_render, tone_id, amplitude_id, swn,
            tone_phase, step1, step2, active, dual, soft_clip, INV_127, rad, half_pi, samples,
            new_swn, new_tp)
    return samples, new_swn, new_tp
