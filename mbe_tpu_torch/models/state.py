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
from ..ops.cuda import select as lane_select
from ..tables import T

NBANDS = 57

MUTING_THRESHOLD_IMBE = float(np.float32(0.0875))
MUTING_THRESHOLD_AMBE = float(np.float32(0.096))
MAX_FRAME_REPEATS = 4
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


def default_leaves(ambe: bool = False) -> Parms:
    """JMBE defaults, IMBE (mbelib.c:368-409) or AMBE W124
    (ambe_common.c:192-229), as constant leaves: each leaf a Python number,
    the same on every lane. The selects take such leaves as they are (the
    kernel writes them from immediates); `materialize` makes tensors of
    them."""
    return Parms(
        w0=float(T.default_w0[0 if ambe else 2]), L=15 if ambe else 39, K=0 if ambe else 12,
        Vl=0, Ml=1.0, log2Ml=0.0, PHIl=0.0, PSIl=0.0, gamma=0.0, tonePhase=0, swn=0,
        localEnergy=DEFAULT_LOCAL_ENERGY, amplitudeThreshold=DEFAULT_AMPLITUDE_THRESHOLD,
        errorRate=0.0, errorCountTotal=0, errorCount4=0, repeatCount=0,
        mutingThreshold=MUTING_THRESHOLD_AMBE if ambe else MUTING_THRESHOLD_IMBE,
        previousUw=0.0, noiseSeed=-1.0, noisePrevSeed=-1.0)


# the leading axes and dtype of each leaf (the channel axis follows)
_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
LEAF_LAYOUT = dict(
    w0=((), _F32), L=((), _I32), K=((), _I32), Vl=((NBANDS,), _I32), Ml=((NBANDS,), _F32),
    log2Ml=((NBANDS,), _F32), PHIl=((NBANDS,), _F32), PSIl=((NBANDS,), _F32), gamma=((), _F32),
    tonePhase=((), _I64), swn=((), _I64), localEnergy=((), _F32), amplitudeThreshold=((), _I32),
    errorRate=((), _F32), errorCountTotal=((), _I32), errorCount4=((), _I32),
    repeatCount=((), _I32), mutingThreshold=((), _F32), previousUw=((128,), _F32),
    noiseSeed=((), _F32), noisePrevSeed=((), _F32))


def materialize(p: Parms, c: int, device) -> Parms:
    """p with each constant leaf made a tensor of its leaf's shape and dtype
    over c channels on `device`; tensor leaves are kept as they are."""
    def leaf(k, v):
        if isinstance(v, torch.Tensor):
            return v
        rows, dtype = LEAF_LAYOUT[k]
        return torch.full((*rows, c), v, dtype=dtype, device=device)

    return Parms(**{k: leaf(k, getattr(p, k)) for k in PARMS_FIELDS})


def checked_device(device) -> torch.device:
    """torch.device(device); a CUDA device without a GPU raises, so that
    nothing runs on the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the CPU")
    return device


def seeded_rngs(seed, channels: int, device):
    """mbe_setThreadRngSeed (mbelib.c:173-181) per channel: seed [C] or a
    scalar, uint32 values (a tensor, or anything numpy takes); 0 maps to
    0x6D25357B. Returns (comfort_rng [3, C] i64, lcg_prime [C] f32) on
    `device`: the Java Random seeded with it, the LCG prime seed % 53125."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    else:
        seed = torch.as_tensor(np.asarray(seed, np.int64) & 0xFFFFFFFF, device=device)
    seed = torch.broadcast_to(seed, (channels,))
    seed = torch.where(seed == 0, 0x6D25357B, seed)
    return noise.java_random_init(seed), (seed % noise.LCG_M).to(torch.float32)


def init_state(channels: int, rng_seed=None, carry_enh: bool = True,
               device="cuda") -> ChannelState:
    """mbe_initMbeParms for a batch of channels (+ RNG state) on `device`.

    rng_seed: optional [C] (or scalar) uint32 seed, the equivalent of
    mbe_setThreadRngSeed (mbelib.c:173-181): 0 maps to 0x6D25357B, the
    Java Random is seeded with it and the LCG prime is seed % 53125. None
    leaves the RNGs on their unseeded defaults (Java Random 0x12345678,
    LCG 3147). carry_enh=False drops the prev_mp_enhanced copy (IMBE-only
    streams). The state goes on the GPU unless the caller names another
    device (device="cpu" runs the plain PyTorch path); without a GPU the
    default raises.
    """
    device = checked_device(device)
    p = materialize(default_leaves(), channels, device)
    if rng_seed is None:
        comfort = noise.java_random_init(torch.full(
            (channels,), 0x12345678, dtype=torch.int64, device=device))
        lcg_prime = torch.full((channels,), noise.LCG_DEFAULT_SEED,
                               dtype=torch.float32, device=device)
    else:
        comfort, lcg_prime = seeded_rngs(rng_seed, channels, device)
    return ChannelState(
        cur=p, prev=map_parms(torch.clone, p),
        enh=map_parms(torch.clone, p) if carry_enh else None,
        comfort_rng=comfort, lcg_prime=lcg_prime)


def _lane_mask(mask, x):
    return mask.reshape((1,) * (x.ndim - mask.ndim) + tuple(mask.shape))


def select_many(selects) -> list[Parms]:
    """Several first-match-wins lane selects in one call: `selects` is a
    list of (cases, default), one per output. Output i is, per lane and
    leaf, the source of its first case (mask [C] bool, source) whose mask
    is set, else its default's. A source or default may hold constant
    leaves (Python numbers, as `default_leaves`); a case's source may be an
    int j < i instead: output j of this call. CUDA tensors go to the
    lane-select kernel (ops/cuda/select.py, one launch for the call),
    anything else to the plain form, select_many_reference; the outputs are
    equal bit for bit."""
    if selects[0][0][0][0].device.type == "cuda":
        def leaves(p):
            return p if isinstance(p, int) else [getattr(p, k) for k in PARMS_FIELDS]

        outs = lane_select.lane_select(
            [([(m, leaves(t)) for m, t in cases], leaves(d)) for cases, d in selects])
        return [Parms(**dict(zip(PARMS_FIELDS, o))) for o in outs]
    return select_many_reference(selects)


def select_many_reference(selects) -> list[Parms]:
    """The plain form of select_many: per output, leaf and case (last case
    first) a broadcast torch.where, the constant leaves made tensors first.
    A case leaf that is the leaf already selected (the default's own,
    before any later case applied) costs nothing."""
    outs = []
    for cases, default in selects:
        c, device = cases[0][0].shape[0], cases[0][0].device

        def resolve(p):
            return outs[p] if isinstance(p, int) else materialize(p, c, device)

        default = resolve(default)
        cases = [(m, resolve(t)) for m, t in cases]
        out = {}
        for k in PARMS_FIELDS:
            x = getattr(default, k)
            for m, t in reversed(cases):
                src = getattr(t, k)
                if src is not x:
                    x = torch.where(_lane_mask(m, src), src, x)
            out[k] = x
        outs.append(Parms(**out))
    return outs


def select(mask, a: Parms, b: Parms) -> Parms:
    """Lane-wise select: a where mask [C] else b, per leaf (the channel
    axis is minor, so the mask broadcasts on leading axes)."""
    return select_many([([(mask, a)], b)])[0]


def select_tree(mask, a: ChannelState, b: ChannelState) -> ChannelState:
    """Lane-wise select over two matching ChannelStates."""
    return map_state(lambda x, y: torch.where(_lane_mask(mask, x), x, y), a, b)


def select_cases(cases, default: Parms) -> Parms:
    """First-match-wins lane select: select_cases([(m1, t1), (m2, t2)], d)
    is t1 where m1, else t2 where m2, else d (select_many's one output)."""
    return select_many([(cases, default)])[0]


def erasure_parms(mp: Parms, continuity: Parms) -> Parms:
    """mbe_setAmbeErasureParms_common (ambe_common.c:231-260): the W120
    model (w0 = 0, L = 9) with phase and noise continuity taken from
    `continuity`; error, repeat and muting fields keep mp's values. The
    model's leaves are constant leaves."""
    d = default_leaves(ambe=True)
    return dataclasses.replace(
        mp, swn=d.swn, tonePhase=d.tonePhase, w0=0.0, L=9, K=d.K, gamma=d.gamma, Ml=d.Ml,
        Vl=d.Vl, log2Ml=d.log2Ml, localEnergy=d.localEnergy,
        amplitudeThreshold=d.amplitudeThreshold,
        **{k: getattr(continuity, k) for k in ("PHIl", "PSIl", "noiseSeed", "noisePrevSeed",
                                               "previousUw")})


def imbe_headroom_reset(mp: Parms) -> Parms:
    """imbe_reset_headroom_defaults (imbe7200x4400.c:56-81): default voice
    model (constant leaves), preserving error metrics and synthesis
    continuity state."""
    keep = ("PHIl", "PSIl", "errorRate", "errorCountTotal", "errorCount4",
            "previousUw", "noiseSeed", "noisePrevSeed")
    return dataclasses.replace(default_leaves(), **{k: getattr(mp, k) for k in keep})


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
