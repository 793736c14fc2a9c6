"""The FSM's lane selects on the CPU: select_many's plain form against a
per-lane numpy statement of the first-match-wins rule (chained outputs
and constant leaves included), the constant-leaf defaults, erasure model
and headroom reset against the JAX package's tensors, and the lane-select
kernel's argument struct (ops/cuda/select.py `pack`) run through a numpy
emulation of csrc/select.cu's algorithm, at random and at every call site
of the codecs' FSMs, bit for bit against the plain form.
"""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mbe_tpu.models import state as jst
from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import ambe
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops.cuda import select as ls

VECTORS = Path(__file__).resolve().parent / "vectors"
INT_VIEW = {torch.float32: torch.int32, torch.int32: torch.int32, torch.int64: torch.int64}


def _bits(x):
    """x's bits as an integer tensor (float32 as int32: -0.0 and NaN
    payloads count)."""
    return x.view(INT_VIEW[x.dtype])


def _random_parms(rng, c, const_keys=()):
    """Parms of random leaves over c channels (float leaves with -0.0 and a
    NaN payload in some lanes, uint32-valued int64 leaves); the leaves of
    `const_keys` are constants instead."""
    out = {}
    for k in st.PARMS_FIELDS:
        rows, dtype = st.LEAF_LAYOUT[k]
        shape = (*rows, c)
        if k in const_keys:
            out[k] = float(rng.normal()) if dtype == torch.float32 else int(rng.integers(0, 99))
            continue
        if dtype == torch.float32:
            a = rng.normal(size=shape).astype(np.float32)
            a.reshape(-1)[::7] = -0.0
            a.view(np.int32).reshape(-1)[3::11] = 0x7FC0_1234
        elif dtype == torch.int32:
            a = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
        else:
            a = rng.integers(0, 2**32, shape, dtype=np.int64)
        out[k] = torch.from_numpy(a)
    return st.Parms(**out)


def _masks(rng, c, n):
    """n [C] bool masks: random, then all true, all false, and overlapping
    halves in turn."""
    kinds = [lambda: rng.random(c) < 0.4, lambda: np.ones(c, bool), lambda: np.zeros(c, bool),
             lambda: np.arange(c) < (c + 1) // 2, lambda: np.arange(c) >= c // 3]
    return [torch.from_numpy(kinds[int(rng.integers(0, len(kinds)))]()) for _ in range(n)]


def _random_selects(rng, c):
    """Three outputs of three cases each: sources random Parms (some with
    constant leaves, one the AMBE defaults, several sharing their Ml
    tensor), later outputs naming earlier ones."""
    pool = [_random_parms(rng, c) for _ in range(4)]
    pool.append(_random_parms(rng, c, const_keys=("w0", "Vl", "swn", "previousUw")))
    pool[:3] = [dataclasses.replace(p, Ml=pool[0].Ml) for p in pool[:3]]
    pool.append(st.default_leaves(ambe=True))
    selects = []
    for o in range(3):
        masks = _masks(rng, c, 3)
        srcs = [pool[int(rng.integers(0, len(pool)))] for _ in range(3)]
        if o > 0:
            srcs[int(rng.integers(0, 3))] = int(rng.integers(0, o))
        selects.append((list(zip(masks, srcs)), pool[int(rng.integers(0, 5))]))
    return selects


def _first_match_reference(selects, c):
    """The rule, lane by lane in numpy: output i's leaf is that of its
    first case whose mask is set, else its default's; an int source is
    output j's leaf on that lane; a constant the same on every lane."""
    outs = []
    for cases, default in selects:
        out = {}
        for k in st.PARMS_FIELDS:
            rows, dtype = st.LEAF_LAYOUT[k]
            col = np.empty((*rows, c), np.int64)
            for lane in range(c):
                src = next((t for m, t in cases if bool(m[lane])), default)
                x = outs[src][k] if isinstance(src, int) else getattr(src, k)
                if isinstance(x, np.ndarray):
                    col[..., lane] = x[..., lane]
                elif isinstance(x, torch.Tensor):
                    col[..., lane] = _bits(x)[..., lane].numpy()
                elif dtype == torch.float32:
                    col[..., lane] = np.float32(x).view(np.int32)
                else:
                    col[..., lane] = x
            out[k] = col
        outs.append(out)
    return outs


def emulate(selects, args, outputs):
    """csrc/select.cu's algorithm over `args` (pack's struct) in numpy, one
    lane at a time (the kernel's 4-lane vectors change only how a lane's
    words move): per output the first set mask's index packed two bits an
    output, then per segment each lane's source resolved through kind and
    src (through earlier outputs' choices), read from the pointer it names
    (a source leaf, never an output) or taken from a constant's bits, and
    written into the output leaf out[o][k]."""
    c = args.c
    sources = {}
    for cases, default in selects:
        for t in [t for _, t in cases if not isinstance(t, int)] + [default]:
            for k, x in enumerate(t):
                if isinstance(x, torch.Tensor):
                    sources[x.data_ptr(), k] = x
    masks = {m.data_ptr(): m for cases, _ in selects for m, _ in cases}
    pick = np.zeros(c, np.int64)
    for o in range(args.n_outputs):
        j = np.full(c, args.n_cases[o], np.int64)
        for q in reversed(range(args.n_cases[o])):
            j = np.where(masks[args.mask[o][q]].numpy(), q, j)
        pick |= j << (2 * o)
    for s in range(args.n_segments):
        o, k = args.seg_out[s], args.seg_leaf[s]
        rows = args.seg_start[s + 1] - args.seg_start[s]
        out = outputs[o][k]
        assert rows * c == out.numel()
        assert out.data_ptr() == args.out[o][k]
        col = np.empty((rows, c), np.int64)
        for lane in range(c):
            oo = o
            j = (pick[lane] >> (2 * oo)) & 3
            kind, bits = args.kind[oo][j][k], args.src[oo][j][k]
            while kind == ls.OUTPUT:
                oo = bits
                j = (pick[lane] >> (2 * oo)) & 3
                kind, bits = args.kind[oo][j][k], args.src[oo][j][k]
            if kind == ls.CONSTANT:
                col[:, lane] = bits
            else:
                assert kind == ls.TENSOR
                col[:, lane] = _bits(sources[bits, k]).reshape(rows, c)[:, lane].numpy()
        wide = np.int32 if args.leaf_bytes[k] == 4 else np.int64
        _bits(out).copy_(torch.from_numpy(col.astype(wide)).reshape(out.shape))


def _leaves(p):
    return p if isinstance(p, int) else [getattr(p, k) for k in st.PARMS_FIELDS]


def _kernel_form(selects):
    return [([(m, _leaves(t)) for m, t in cases], _leaves(d)) for cases, d in selects]


def _emulated(selects):
    """select_many through pack and the emulation: the outputs as Parms,
    and whether pack chose the 16-byte form."""
    sel = _kernel_form(selects)
    args, vec, outputs = ls.pack(sel)
    emulate(sel, args, outputs)
    return [st.Parms(**dict(zip(st.PARMS_FIELDS, o))) for o in outputs], vec


def _assert_same(got, want, msg=""):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in st.PARMS_FIELDS:
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and a.shape == b.shape, (msg, i, k)
            assert torch.equal(_bits(a), _bits(b)), (msg, i, k)


@pytest.mark.parametrize("c", [1, 5, 33, 64])
def test_select_many_first_match_wins(c):
    """The plain form is the first-match-wins rule lane by lane, with
    constant leaves and outputs chained to earlier outputs of the call."""
    rng = np.random.default_rng(c)
    for _ in range(3):
        selects = _random_selects(rng, c)
        got = st.select_many(selects)
        want = _first_match_reference(selects, c)
        for o, (g, w) in enumerate(zip(got, want)):
            for k in st.PARMS_FIELDS:
                np.testing.assert_array_equal(_bits(getattr(g, k)).numpy(), w[k],
                                              err_msg=f"output {o} {k}")


@pytest.mark.parametrize("c", [1, 5, 33, 64])
def test_emulated_kernel_equals_plain(c):
    """pack's struct through the emulation equals the plain form bit for
    bit; the 16-byte form is chosen exactly when C % 4 == 0 (every pointer
    here aligned)."""
    rng = np.random.default_rng(100 + c)
    for _ in range(3):
        selects = _random_selects(rng, c)
        got, vec = _emulated(selects)
        _assert_same(got, st.select_many_reference(selects))
        assert vec == (c % 4 == 0)


def test_pack_passes_one_tensor_through():
    """A leaf that is one tensor in every source (through an earlier
    output too) is that tensor, as in the plain form, and is not written:
    no segment for it, and a later output naming it reads the tensor."""
    rng = np.random.default_rng(4)
    a, b = _random_parms(rng, 8), _random_parms(rng, 8)
    b = dataclasses.replace(b, Ml=a.Ml, previousUw=a.previousUw)
    m1, m2 = _masks(rng, 8, 2)
    selects = [([(m1, b)], a), ([(m2, 0)], a)]
    args, _, outputs = ls.pack(_kernel_form(selects))
    for o in range(2):
        assert outputs[o][st.PARMS_FIELDS.index("Ml")] is a.Ml
        assert outputs[o][st.PARMS_FIELDS.index("previousUw")] is a.previousUw
    written = {(args.seg_out[s], st.PARMS_FIELDS[args.seg_leaf[s]])
               for s in range(args.n_segments)}
    assert len(written) == args.n_segments == 2 * (len(st.PARMS_FIELDS) - 2)
    assert ("Ml", "previousUw") not in {k for _, k in written}
    got, _ = _emulated(selects)
    _assert_same(got, st.select_many_reference(selects))


def test_pack_scalar_form_for_unaligned_leaves():
    """A leaf that starts off a 16-byte boundary (a view one element in)
    takes the one-channel form; the result is unchanged."""
    rng = np.random.default_rng(3)
    a, b = _random_parms(rng, 8), _random_parms(rng, 8)
    wide = torch.arange(9, dtype=torch.float32)
    b = dataclasses.replace(b, gamma=wide[1:])
    selects = [([(torch.from_numpy(rng.random(8) < 0.5), b)], a)]
    got, vec = _emulated(selects)
    assert not vec
    _assert_same(got, st.select_many_reference(selects))


@pytest.mark.parametrize("ambe_mode", [False, True], ids=["imbe", "ambe"])
def test_default_leaves_match_jax(ambe_mode):
    """The constant-leaf defaults made tensors equal the JAX package's
    default tensors leaf for leaf, bits and dtypes; so do the erasure model
    and the headroom reset of random parameters."""
    c = 6
    want = jst._default_parms(c, ambe_mode)
    got = st.materialize(st.default_leaves(ambe_mode), c, "cpu")
    for k in st.PARMS_FIELDS:
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32
                                      else w.astype(g.dtype), err_msg=k)
    rng = np.random.default_rng(int(ambe_mode))
    mp, cont = _random_parms(rng, c), _random_parms(rng, c)
    mp_np = st.state_to_numpy(st.ChannelState(mp, mp, None, torch.zeros((3, c), dtype=torch.int64),
                                              torch.zeros(c))).cur
    cont_np = st.state_to_numpy(st.ChannelState(cont, cont, None,
                                                torch.zeros((3, c), dtype=torch.int64),
                                                torch.zeros(c))).cur
    jparms = [jst.Parms(**{k: np.asarray(getattr(p, k)) for k in st.PARMS_FIELDS})
              for p in (mp_np, cont_np)]
    if ambe_mode:
        got, want = st.erasure_parms(mp, cont), jst.erasure_parms(*jparms)
    else:
        got, want = st.imbe_headroom_reset(mp), jst.imbe_headroom_reset(jparms[0])
    got = st.materialize(got, c, "cpu")
    for k in st.PARMS_FIELDS:
        g = _bits(getattr(got, k)).numpy()
        w = np.asarray(getattr(want, k))
        w = w.view(np.int32) if w.dtype == np.float32 else w.astype(g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


CALL_SITE_RUNS = [("e2e_imbe7200", "imbe7200", False), ("e2e_imbe7100_soft", "imbe7100", True),
                  ("e2e_ambe2450_soft", "ambe2450", True), ("e2e_ambe2400", "ambe2400", False)]


@pytest.mark.parametrize("name,codec,soft", CALL_SITE_RUNS, ids=[r[0] for r in CALL_SITE_RUNS])
def test_emulated_kernel_at_every_call_site(name, codec, soft, monkeypatch):
    """Six frames of a golden with every select of the FSM (IMBE's one,
    AMBE's prepare, update, speech-path and commit selects) packed and
    emulated, each call bit-equal to the plain form; the selects per step
    are those the kernel's launch counts expect (1 IMBE, 4 AMBE)."""
    calls = []

    def checked(selects):
        got, _ = _emulated(selects)
        want = st.select_many_reference(selects)
        _assert_same(got, want, f"call {len(calls)}")
        calls.append(len(selects))
        return want

    monkeypatch.setattr(st, "select_many", checked)
    monkeypatch.setattr(ambe, "select_many", checked)
    vec = dict(np.load(VECTORS / f"{name}.npz"))
    T, C = 6, vec["frames"].shape[1]
    state = st.init_state(C, rng_seed=vec["seeds"], carry_enh=codec.startswith("ambe"),
                          device="cpu")
    frames = torch.as_tensor(vec["frames"])
    rel = torch.as_tensor(vec["rel"]) if soft else None
    for t in range(T):
        state, *_ = pipeline.step(codec, frames[t], state, None if rel is None else rel[t])
    assert len(calls) == T * (4 if codec.startswith("ambe") else 1)


def test_pack_rejects_bad_inputs():
    """Wrong dtype, shape, contiguity, counts, chained output, constant,
    and any device but CUDA for the launch."""
    rng = np.random.default_rng(5)
    a, b = _random_parms(rng, 8), _random_parms(rng, 8)
    m = torch.from_numpy(rng.random(8) < 0.5)

    def sel(**kw):
        return _kernel_form([([(m, dataclasses.replace(b, **kw))], a)])

    with pytest.raises(ValueError, match="float64"):
        ls.pack(sel(w0=torch.zeros(8, dtype=torch.float64)))
    with pytest.raises(ValueError, match="shape"):
        ls.pack(sel(w0=torch.zeros(7)))
    with pytest.raises(ValueError, match="must be"):
        ls.pack(sel(Ml=torch.zeros((56, 8))))
    with pytest.raises(ValueError, match="contiguous"):
        ls.pack(sel(Ml=torch.zeros((8, 57)).T))
    with pytest.raises(ValueError, match="float constant"):
        ls.pack(sel(L=1.5))
    with pytest.raises(ValueError, match="out of range"):
        ls.pack(sel(L=2**31))
    with pytest.raises(ValueError, match="mask"):
        ls.pack(_kernel_form([([(m.int(), b)], a)]))
    with pytest.raises(ValueError, match="contiguous"):
        ls.pack(_kernel_form([([(torch.zeros((8, 2), dtype=torch.bool)[:, 0], b)], a)]))
    with pytest.raises(ValueError, match="cases"):
        ls.pack(_kernel_form([([(m, b)] * 4, a)]))
    with pytest.raises(ValueError, match="outputs"):
        ls.pack(_kernel_form([([(m, b)], a)] * 4))
    with pytest.raises(ValueError, match="earlier output"):
        ls.pack(_kernel_form([([(m, 0)], a)]))
    with pytest.raises(ValueError, match="constant in every source"):
        ls.pack(_kernel_form([([(m, st.default_leaves())], dataclasses.replace(a, w0=1.0))]))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ls.lane_select(sel())


def test_args_fit_a_kernel_parameter_block():
    """The argument struct, passed by value, fits CUDA's 4 KB of kernel
    parameters; its leaf tables hold a Parms."""
    assert ctypes.sizeof(ls.Args) <= 4096
    assert ls.MAX_LEAVES == len(st.PARMS_FIELDS)
