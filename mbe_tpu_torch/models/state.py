"""Batched per-channel codec state (port of mbe_tpu.models.state).

Channel axis minor, leaf for leaf as in the JAX package: scalars [C],
band arrays [57, C], the WOLA buffer [128, C]. The JAX uint32 leaves
(tonePhase, swn and the comfort_rng limbs) are int64 tensors holding the
same values: torch has no arithmetic on uint32.
"""

import dataclasses

import numpy as np
import torch

from ..ops import noise
from ..tables import T

NBANDS = 57

MUTING_THRESHOLD_IMBE = float(np.float32(0.0875))
DEFAULT_LOCAL_ENERGY = 75000.0
DEFAULT_AMPLITUDE_THRESHOLD = 20480

# JAX leaves held as uint32, carried here as int64
UINT32_PARMS = ("tonePhase", "swn")


@dataclasses.dataclass
class Parms:
    """Batched mirror of mbe_parms (mbelib.h:88-139), channel axis minor."""

    w0: torch.Tensor            # [C] f32
    L: torch.Tensor             # [C] i32
    K: torch.Tensor             # [C] i32
    Vl: torch.Tensor            # [57, C] i32
    Ml: torch.Tensor            # [57, C] f32
    log2Ml: torch.Tensor        # [57, C] f32
    PHIl: torch.Tensor          # [57, C] f32
    PSIl: torch.Tensor          # [57, C] f32
    gamma: torch.Tensor         # [C] f32
    tonePhase: torch.Tensor     # [C] i64 (uint32 values)
    swn: torch.Tensor           # [C] i64 (uint32 values)
    localEnergy: torch.Tensor   # [C] f32
    amplitudeThreshold: torch.Tensor  # [C] i32
    errorRate: torch.Tensor     # [C] f32
    errorCountTotal: torch.Tensor     # [C] i32
    errorCount4: torch.Tensor   # [C] i32
    repeatCount: torch.Tensor   # [C] i32
    mutingThreshold: torch.Tensor     # [C] f32
    previousUw: torch.Tensor    # [128, C] f32 = mbe_parms.previousUw[128:256]
    noiseSeed: torch.Tensor     # [C] f32 (<0 = cold start sentinel)
    noisePrevSeed: torch.Tensor  # [C] f32 (<0 = zero overlap)


PARMS_FIELDS = tuple(f.name for f in dataclasses.fields(Parms))


@dataclasses.dataclass
class ChannelState:
    """Decoder state: the parms triplet plus per-channel RNG state. `enh`
    is None for IMBE-only streams (enh == cur at every IMBE step boundary,
    imbe7200x4400.c:856)."""

    cur: Parms
    prev: Parms
    enh: Parms | None
    comfort_rng: torch.Tensor  # [3, C] i64 (16-bit limbs, uint32 values)
    lcg_prime: torch.Tensor    # [C] f32


def map_parms(fn, *ps: Parms) -> Parms:
    """Parms whose every leaf is fn(leaf of each of ps)."""
    return Parms(**{k: fn(*(getattr(p, k) for p in ps)) for k in PARMS_FIELDS})


def map_state(fn, *sts: ChannelState) -> ChannelState:
    """ChannelState whose every leaf is fn(leaf of each of sts); enh stays
    None where the first state has none."""
    return ChannelState(
        cur=map_parms(fn, *(s.cur for s in sts)),
        prev=map_parms(fn, *(s.prev for s in sts)),
        enh=(None if sts[0].enh is None
             else map_parms(fn, *(s.enh for s in sts))),
        comfort_rng=fn(*(s.comfort_rng for s in sts)),
        lcg_prime=fn(*(s.lcg_prime for s in sts)))


def _default_parms(c: int, device) -> Parms:
    """JMBE IMBE defaults (mbelib.c:368-409)."""
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return Parms(
        w0=full((c,), float(T.default_w0[2]), f32),
        L=full((c,), 39, i32),
        K=full((c,), 12, i32),
        Vl=full((NBANDS, c), 0, i32),
        Ml=full((NBANDS, c), 1.0, f32),
        log2Ml=full((NBANDS, c), 0.0, f32),
        PHIl=full((NBANDS, c), 0.0, f32),
        PSIl=full((NBANDS, c), 0.0, f32),
        gamma=full((c,), 0.0, f32),
        tonePhase=full((c,), 0, torch.int64),
        swn=full((c,), 0, torch.int64),
        localEnergy=full((c,), DEFAULT_LOCAL_ENERGY, f32),
        amplitudeThreshold=full((c,), DEFAULT_AMPLITUDE_THRESHOLD, i32),
        errorRate=full((c,), 0.0, f32),
        errorCountTotal=full((c,), 0, i32),
        errorCount4=full((c,), 0, i32),
        repeatCount=full((c,), 0, i32),
        mutingThreshold=full((c,), MUTING_THRESHOLD_IMBE, f32),
        previousUw=full((128, c), 0.0, f32),
        noiseSeed=full((c,), -1.0, f32),
        noisePrevSeed=full((c,), -1.0, f32),
    )


def init_state(channels: int, rng_seed=None, carry_enh: bool = True,
               device="cpu") -> ChannelState:
    """mbe_initMbeParms for a batch of channels (+ RNG state) on `device`.

    rng_seed: optional [C] (or scalar) uint32 seed, the equivalent of
    mbe_setThreadRngSeed (mbelib.c:173-181): 0 maps to 0x6D25357B, the
    Java Random is seeded with it and the LCG prime is seed % 53125. None
    leaves the RNGs on their unseeded defaults (Java Random 0x12345678,
    LCG 3147). carry_enh=False drops the prev_mp_enhanced copy (IMBE-only
    streams).
    """
    device = torch.device(device)
    p = _default_parms(channels, device)
    if rng_seed is None:
        comfort = noise.java_random_init(torch.full(
            (channels,), 0x12345678, dtype=torch.int64, device=device))
        lcg_prime = torch.full((channels,), noise.LCG_DEFAULT_SEED,
                               dtype=torch.float32, device=device)
    else:
        seed = torch.as_tensor(np.asarray(rng_seed, np.int64) & 0xFFFFFFFF,
                               device=device)
        seed = torch.broadcast_to(seed, (channels,))
        seed = torch.where(seed == 0, 0x6D25357B, seed)
        comfort = noise.java_random_init(seed)
        lcg_prime = (seed % noise.LCG_M).to(torch.float32)
    return ChannelState(
        cur=p, prev=map_parms(torch.clone, p),
        enh=map_parms(torch.clone, p) if carry_enh else None,
        comfort_rng=comfort, lcg_prime=lcg_prime)


def _lane_mask(mask, x):
    return mask.reshape((1,) * (x.ndim - mask.ndim) + tuple(mask.shape))


def select(mask, a: Parms, b: Parms) -> Parms:
    """Lane-wise select: a where mask [C] else b, per leaf (the channel
    axis is minor, so the mask broadcasts on leading axes)."""
    return map_parms(lambda x, y: torch.where(_lane_mask(mask, x), x, y), a, b)


def select_tree(mask, a: ChannelState, b: ChannelState) -> ChannelState:
    """Lane-wise select over two matching ChannelStates."""
    return map_state(lambda x, y: torch.where(_lane_mask(mask, x), x, y), a, b)


def select_cases(cases, default: Parms) -> Parms:
    """First-match-wins lane select: select_cases([(m1, t1), (m2, t2)], d)
    is t1 where m1, else t2 where m2, else d. A case leaf that is the
    default's own leaf costs nothing."""
    out = {}
    for k in PARMS_FIELDS:
        x = getattr(default, k)
        for m, t in reversed(cases):
            src = getattr(t, k)
            if src is not getattr(default, k):
                x = torch.where(_lane_mask(m, src), src, x)
        out[k] = x
    return Parms(**out)


def imbe_headroom_reset(mp: Parms) -> Parms:
    """imbe_reset_headroom_defaults (imbe7200x4400.c:56-81): default voice
    model, preserving error metrics and synthesis continuity state."""
    d = _default_parms(mp.w0.shape[0], mp.w0.device)
    keep = ("PHIl", "PSIl", "errorRate", "errorCountTotal", "errorCount4",
            "previousUw", "noiseSeed", "noisePrevSeed")
    return dataclasses.replace(d, **{k: getattr(mp, k) for k in keep})


def state_from_numpy(tree, device) -> ChannelState:
    """A JAX ChannelState whose leaves were fetched as numpy arrays (any
    object with the same attribute names) -> the port's state on `device`.
    uint32 leaves become int64 holding the same values."""
    def leaf(x):
        a = np.array(x)  # a writable, C-contiguous copy
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    def parms(p):
        return Parms(**{k: leaf(getattr(p, k)) for k in PARMS_FIELDS})

    return ChannelState(
        cur=parms(tree.cur), prev=parms(tree.prev),
        enh=None if tree.enh is None else parms(tree.enh),
        comfort_rng=leaf(tree.comfort_rng), lcg_prime=leaf(tree.lcg_prime))


def state_to_numpy(state: ChannelState) -> ChannelState:
    """The port's state -> the same structure with numpy leaves in the JAX
    package's dtypes (the int64 uint32-valued leaves back to uint32)."""
    def parms(p):
        out = {}
        for k in PARMS_FIELDS:
            a = getattr(p, k).cpu().numpy()
            out[k] = a.astype(np.uint32) if k in UINT32_PARMS else a
        return Parms(**out)

    return ChannelState(
        cur=parms(state.cur), prev=parms(state.prev),
        enh=None if state.enh is None else parms(state.enh),
        comfort_rng=state.comfort_rng.cpu().numpy().astype(np.uint32),
        lcg_prime=state.lcg_prime.cpu().numpy())
