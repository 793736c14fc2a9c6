"""Noise generators: unvoiced LCG (affine jump) and Java-Random comfort
noise, as per-channel state transforms (port of mbe_tpu.ops.noise).

Unvoiced LCG (mbe_unvoiced_fft.c:277-341): x' = (171x + 11213) mod 53125,
all 160 samples of a frame at once from the jump tables lcg_A/lcg_B.

Comfort noise (mbe_adaptive.c:51-130): java.util.Random's 48-bit LCG,
kept as three 16-bit limbs [3, C]. The limbs are int64 tensors holding
uint32 values (torch has no arithmetic on uint32); every step masks
explicitly, and the 16-bit limb scheme stays because a single 48-bit
product would overflow int64.

comfort_noise and generate_noise_with_overlap run their plain forms
(*_reference) for CPU tensors and the hand-written kernel of
ops/cuda/sources.py for CUDA tensors (any other device raises there); the
plain forms are the kernel's oracle.
"""

from functools import lru_cache

import numpy as np
import torch

from ..tables import T
from .cuda import sources

LCG_M = 53125
LCG_DEFAULT_SEED = 3147.0

_JMULT = 0x5DEECE66D
_JM0 = _JMULT & 0xFFFF
_JM1 = (_JMULT >> 16) & 0xFFFF
_JM2 = (_JMULT >> 32) & 0xFFFF
_JADD = 0xB
_M16 = 0xFFFF

COMFORT_GAIN = float(np.float32((0.003 * 32767.0) / 7.0))


@lru_cache(maxsize=None)
def _lcg_tables(device):
    """(A, B) jump tables [161, 1] int64: state_{n+k} = A[k]*s + B[k]."""
    a = torch.as_tensor(np.asarray(T.lcg_A, np.int64), device=device)
    b = torch.as_tensor(np.asarray(T.lcg_B, np.int64), device=device)
    return a[:, None], b[:, None]


def lcg_block(seed_int, count=160):
    """LCG samples and final state via affine jump.

    Args: seed_int [C] int (current LCG state, already mod 53125).
    Returns: (samples [count, C] int64 — value BEFORE each update,
    next_state [C] int64). Products are < 53125^2 < 2^32: exact in int64.
    """
    a, b = _lcg_tables(seed_int.device)
    s = seed_int.to(torch.int64)
    samples = (a[:count] * s[None, :] + b[:count]) % LCG_M
    next_state = (a[count] * s + b[count]) % LCG_M
    return samples, next_state


def generate_noise_with_overlap(noise_seed, noise_prev_seed, prime_value):
    """mbe_generate_noise_with_overlap (mbe_unvoiced_fft.c:305-341): the
    plain form below for CPU tensors, the kernel of ops/cuda/sources.py
    (bit for bit the same) for CUDA tensors, which are three [C] f32.

    Returns (buffer [256, C] f32, new_seed [C] f32, new_prev_seed [C] f32).
    """
    if noise_seed.device.type == "cpu":
        return generate_noise_with_overlap_reference(noise_seed, noise_prev_seed, prime_value)
    return sources.lcg_buffer(noise_seed, noise_prev_seed, prime_value,
                              *_lcg_tables(noise_seed.device))


def generate_noise_with_overlap_reference(noise_seed, noise_prev_seed, prime_value):
    """The plain form of generate_noise_with_overlap, with the 96-sample
    overlap re-expanded from the seed that produced it (samples 64..159 of
    `noise_prev_seed`; < 0 means zeros).

    Returns (buffer [256, C] f32, new_seed [C] f32, new_prev_seed [C] f32);
    cold-start lanes (seed < 0) emit zeros and prime the seed.
    """
    a, b = _lcg_tables(noise_seed.device)
    cold = noise_seed < 0.0
    state = noise_seed.to(torch.int32) % LCG_M
    samples, next_state = lcg_block(torch.clamp(state, min=0), count=160)

    ps = torch.clamp(noise_prev_seed, min=0.0).to(torch.int64) % LCG_M
    overlap = ((a[64:160] * ps[None, :] + b[64:160]) % LCG_M).to(torch.float32)
    overlap = torch.where((noise_prev_seed < 0.0)[None, :], 0.0, overlap)

    warm = torch.cat([overlap, samples.to(torch.float32)], dim=0)  # [256, C]
    buffer = torch.where(cold[None, :], 0.0, warm)
    new_prev_seed = torch.where(cold, -1.0, noise_seed)
    new_seed = torch.where(cold, prime_value, next_state.to(torch.float32))
    return buffer, new_seed, new_prev_seed


def java_random_init(seed):
    """Java Random setSeed: (seed ^ 0x5DEECE66D) & (2^48-1) as three 16-bit
    limbs [3, C] int64 (mbe_adaptive.c:33-38); seed 0 maps to 0x6d25357b
    first (mbe_setThreadRngSeed, mbelib.c:174-180). seed: [C] int holding
    uint32 values."""
    s = seed.to(torch.int64) & 0xFFFFFFFF
    s = torch.where(s == 0, 0x6D25357B, s)
    s0 = (s & _M16) ^ _JM0
    s1 = ((s >> 16) & _M16) ^ _JM1
    s2 = torch.full_like(s, _JM2)  # seed bits 32..47 are 0
    return torch.stack([s0, s1, s2], dim=0)


def _java_jump_tables(n):
    """Affine jump constants state_k = A_k*state + B_k mod 2^48 as 16-bit
    limb arrays [n, 3] (k = 1..n)."""
    A = np.zeros((n, 3), np.int64)
    B = np.zeros((n, 3), np.int64)
    a, b = 1, 0
    mask = (1 << 48) - 1
    for k in range(n):
        a = (a * _JMULT) & mask
        b = (b * _JMULT + _JADD) & mask
        A[k] = [a & _M16, (a >> 16) & _M16, (a >> 32) & _M16]
        B[k] = [b & _M16, (b >> 16) & _M16, (b >> 32) & _M16]
    return A, B


@lru_cache(maxsize=None)
def _java_tables(device):
    A, B = _java_jump_tables(160)
    return (torch.as_tensor(A, device=device)[:, :, None],
            torch.as_tensor(B, device=device)[:, :, None])  # [160, 3, 1]


@lru_cache(maxsize=None)
def _java_jumps(device):
    """(A, B) [160] int64 on `device`: the state after k + 1 steps of
    java.util.Random is A[k]*s + B[k] mod 2^48 (_java_jump_tables's limbs
    joined), for the kernel."""
    shifts = np.array([0, 16, 32], np.int64)
    return tuple(torch.as_tensor((x << shifts).sum(axis=1), device=device)
                 for x in _java_jump_tables(160))


def comfort_noise(limbs, n=160):
    """160 comfort-noise samples + advanced RNG state
    (mbe_synthesizeComfortNoisef, mbe_adaptive.c:117-131): the plain form
    below for CPU tensors, the kernel of ops/cuda/sources.py (bit for bit
    the same) for CUDA tensors.

    Args: limbs [3, C] int64 Java-Random state.
    Returns: (samples [n, C] f32, new_limbs [3, C] int64).
    """
    if limbs.device.type == "cpu":
        return comfort_noise_reference(limbs, n)
    # a shard of a state (a column slice) is strided
    return sources.comfort_noise(limbs.contiguous(), n, *_java_jumps(limbs.device),
                                 COMFORT_GAIN)


def comfort_noise_reference(limbs, n=160):
    """The plain form of comfort_noise: all samples at once from the affine
    jumps with exact 16-bit-limb carries (the scheme of
    mbe_tpu.ops.noise.comfort_noise; int64 partial sums never exceed 2^35,
    and the masks reproduce the uint32 wraparound).

    Args: limbs [3, C] int64 Java-Random state.
    Returns: (samples [n, C] f32, new_limbs [3, C] int64).
    """
    A, B = _java_tables(limbs.device)
    a0, a1, a2 = A[:n, 0], A[:n, 1], A[:n, 2]
    b0, b1, b2 = B[:n, 0], B[:n, 1], B[:n, 2]
    s0, s1, s2 = limbs[0][None, :], limbs[1][None, :], limbs[2][None, :]

    t0 = a0 * s0 + b0
    c0 = t0 >> 16
    p01 = a0 * s1
    p10 = a1 * s0
    t1 = (p01 & _M16) + (p10 & _M16) + b1 + c0
    r1 = t1 & _M16
    c1 = (t1 >> 16) + (p01 >> 16) + (p10 >> 16)
    r2 = (a0 * s2 + a1 * s1 + a2 * s0 + b2 + c1) & _M16

    val = (r2 << 8) | (r1 >> 8)  # next(24): top 24 bits of the state
    u = (val.to(torch.float32) / 16777216.0) * 2.0 - 1.0
    samples = u * COMFORT_GAIN
    new_limbs = torch.stack([t0[n - 1] & _M16, r1[n - 1], r2[n - 1]], dim=0)
    return samples, new_limbs
