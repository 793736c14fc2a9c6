"""AMBE+2 3600x2450 and AMBE 3600x2400 through the port (mbe_tpu_torch),
against the JAX package and the golden vectors.

Integers (ambe_d bits, error counts, flags, integer state) bit-exact; PCM
>= 60 dB SNR per frame and lane and for the int16 stream, the bar
tests/test_e2e.py sets."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from mbe_tpu.models import ambe as jambe
from mbe_tpu.models import state as jst
from mbe_tpu.ops import synth as jsynth
from mbe_tpu.tables import T as JT
from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import ambe
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.ops.cuda import softecc
from mbe_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")
CODECS = ("ambe2450", "ambe2400")
PROCESS = {"ambe2450": ambe.process_ambe2450, "ambe2400": ambe.process_ambe2400}
FSM_FLAGS = (("erasure", pipeline.FLAG_ERASURE), ("tone", pipeline.FLAG_TONE),
             ("repeat", pipeline.FLAG_REPEAT), ("mute", pipeline.FLAG_MUTE))
INT_PARMS = ("L", "K", "Vl", "tonePhase", "swn", "amplitudeThreshold",
             "errorCountTotal", "errorCount4", "repeatCount")


def _jax_parms(p):
    return jst.Parms(**{k: jnp.asarray(v) for k, v in dataclasses.asdict(p).items()})


def _random_parms(rng, c):
    """A JAX Parms with random voice models (numpy leaves)."""
    p = jax.tree.map(np.asarray, jst.init_state(c)).cur
    Ml = rng.uniform(0.05, 4.0, (57, c)).astype(np.float32)
    return dataclasses.replace(
        p, L=rng.integers(9, 57, c).astype(np.int32), Ml=Ml, log2Ml=np.log2(Ml),
        Vl=rng.integers(0, 2, (57, c)).astype(np.int32),
        gamma=rng.uniform(-2, 6, c).astype(np.float32),
        w0=rng.uniform(0.1, 0.6, c).astype(np.float32),
        PHIl=rng.uniform(0, 6.28, (57, c)).astype(np.float32),
        swn=rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32),
        tonePhase=rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32),
        repeatCount=rng.integers(0, 6, c).astype(np.int32))


def _port_parms(p):
    """numpy-leaf Parms (JAX dtypes) -> the port's CPU Parms."""
    return st.state_from_numpy(jst.ChannelState(p, p, None, np.zeros((3, 1), np.uint32),
                                                np.zeros(1, np.float32)), "cpu").cur


def _assert_parms(got, want, msg, float_tol=0.0):
    """Integer leaves equal; float leaves within float_tol of max |want|."""
    for k in st.PARMS_FIELDS:
        a = getattr(got, k).numpy()
        b = np.asarray(getattr(want, k)).astype(a.dtype if k not in st.UINT32_PARMS else np.int64)
        if k in INT_PARMS or float_tol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {k}")
        else:
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= float_tol, f"{msg}: {k} rel err {err}"


# ---------------------------------------------------------------------------
# frame stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_frame_decode_vs_jax(soft):
    """decode_ambe3600_frame against JAX on seeded random frames: ambe_d,
    C0 and protected error counts bit-exact (tolerance 0). A quarter of
    the lanes carry constant (7) or zero reliabilities, where the soft
    decoder's tie-break decides; another eighth are valid codewords with
    one flipped bit, so the Golay24 parity fix is taken."""
    rng = np.random.default_rng(4)
    c = 96
    f = rng.integers(0, 2, (c, 4, 24)).astype(np.int32)
    rel = rng.integers(0, 256, f.shape).astype(np.int32)
    rel[: c // 8] = 0
    rel[c // 8: c // 4] = 7
    for i in range(c // 4, 3 * c // 8):  # C0: an exact Golay codeword, bit 0 odd parity
        cw = np.asarray(JT.golay_codewords)[rng.integers(0, 4096)]
        f[i, 0, 1:24] = cw
        f[i, 0, 0] = (cw.sum() + 1) & 1
    want = jax.jit(jambe.decode_ambe3600_frame)(f, rel) if soft else \
        jax.jit(jambe.decode_ambe3600_frame)(f)
    got = ambe.decode_ambe3600_frame(torch.from_numpy(f), torch.from_numpy(rel) if soft else None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int32 and got[0].shape == (49, c)


def test_soft_frame_runs_two_soft_decodes():
    """A soft AMBE frame decodes through the soft decode (its plain form,
    soft_decode_keys_reference, on the CPU) twice, C0 then C1 (the demod
    seed comes from the decoded C0)."""
    calls = []
    real = softecc.soft_decode_keys_reference

    def counting(bits, rel, idx_hard, code):
        calls.append((code, tuple(bits.shape)))
        return real(bits, rel, idx_hard, code)

    softecc.soft_decode_keys_reference = counting
    try:
        for codec in CODECS:
            pipeline.step(codec, torch.zeros((5, 4, 24), dtype=torch.int32),
                          st.init_state(5, device="cpu"), torch.full((5, 4, 24), 100))
    finally:
        softecc.soft_decode_keys_reference = real
    assert calls == [("golay", (5, 23))] * 4


# ---------------------------------------------------------------------------
# parameter decode
# ---------------------------------------------------------------------------

def test_code_widths_equal_table_rows():
    """Every row gather of the parameter decoders is in range: each code's
    bit width gives exactly its table's row count (b0-indexed tables are
    read with the clamp of bits.lookup instead)."""
    widths = {"AmbeVuv": 5, "AmbePlusVuv": 4, "AmbePRBA24": 9, "AmbePlusPRBA24": 9,
              "AmbePRBA58": 7, "AmbePlusPRBA58": 7, "AmbeHOCb5": 5, "AmbeHOCb6": 4,
              "AmbeHOCb7": 4, "AmbeHOCb8": 3, "AmbePlusHOCb5": 4, "AmbePlusHOCb6": 4,
              "AmbePlusHOCb7": 4, "AmbePlusHOCb8": 4, "AmbeDg": 5, "AmbePlusDg": 6,
              "tone_valid": 8, "tone_freqs": 8}
    for name, bits in widths.items():
        assert np.asarray(getattr(JT, name)).shape[0] == 1 << bits, name
    assert len(JT.AmbeW0table) == len(JT.ambe2450_w0_by_b0) == len(JT.AmbeLtable) == 120
    assert len(JT.ambe2400_f0_by_b0) == len(JT.ambe2400_w0_by_b0) == len(JT.AmbePlusLtable) == 126
    # the block sizes index the size table (0 and 1..17) and each L fills
    # exactly its L bands
    for plus in (False, True):
        _, _, lmprbl, scl = ambe._tl_factored(plus)
        assert lmprbl.min() >= 0 and lmprbl.max() <= 17
        assert ((scl >= 0).sum(axis=1)[9:] == lmprbl.sum(axis=1)[9:]).all()


@pytest.mark.parametrize("plus", [False, True], ids=["ambe2450", "ambe2400"])
def test_tl_tables_and_tl_match_jax(plus):
    """The table builders equal JAX's (tolerance 0), and Tl from random
    codes over every L (0..56) is within 5e-5 of max |Tl|, the bound
    measured between the reference's Tl forms (ROADMAP A8)."""
    M, off, lmprbl, scl = ambe._tl_factored(plus)
    jM, joff, jlm, jscl, _ = jambe._tl_factored(plus)
    np.testing.assert_array_equal(M, jM)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(lmprbl, jlm)
    np.testing.assert_array_equal(scl, jscl)
    np.testing.assert_array_equal(ambe._ri_matrix(), jambe._ri_matrix())

    rng = np.random.default_rng(8 + plus)
    c = 57 * 4
    L = np.tile(np.arange(57, dtype=np.int32), 4)
    Gm = rng.normal(0, 2, (8, c)).astype(np.float32)
    Gm[0] = 0
    rows = [16 if plus else 32, 16, 16, 16 if plus else 8]
    codes = [rng.integers(0, r, c).astype(np.int32) for r in rows]
    if plus:
        codes[3] &= ~1  # the 2400 b8 code is even (its low bit is zero)
    want = np.asarray(jax.jit(jambe._tl_from_codes, static_argnums=6)(L, Gm, *codes, plus))
    got = ambe._tl_from_codes(torch.from_numpy(L), torch.from_numpy(Gm),
                              *map(torch.from_numpy, codes), plus=plus).numpy()
    assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got[:, L == 0], 0.0)


def _param_inputs(codec, seed):
    """Random ambe_d [49, N] over every b0 value (twice each), a quarter
    of the 2450 lanes given the tone signature; random prior states and
    total error counts in -1..8 (negative: no tone BER gate)."""
    rng = np.random.default_rng(seed)
    nb0 = 128
    n = 2 * nb0
    d = rng.integers(0, 2, (49, n)).astype(np.int32)
    b0 = np.tile(np.arange(nb0), 2)
    pos = (0, 1, 2, 3, 37, 38, 39) if codec == "ambe2450" else (0, 1, 2, 3, 4, 5, 48)
    for j, p in enumerate(pos):
        d[p] = (b0 >> (6 - j)) & 1
    if codec == "ambe2450":
        tone = rng.random(n) < 0.25
        d[0:6, tone] = 1
        d[45:49, tone & (rng.random(n) < 0.5)] = 0
    te = rng.integers(-1, 9, n).astype(np.int32)
    return d, _random_parms(rng, n), _random_parms(rng, n), te


@pytest.mark.parametrize("codec", CODECS)
def test_parameter_decode_matches_jax(codec):
    """decode_ambe2450_parms / decode_ambe2400_parms against JAX over every
    b0 (voice, silence, erasure and tone lanes): bad and every integer
    leaf exact; w0 and gamma exact (table reads and one exact add); Ml and
    log2Ml within 5e-5 of their max (the Tl bound, carried through the
    prediction)."""
    d, cur, prev, te = _param_inputs(codec, 21 if codec == "ambe2450" else 22)
    if codec == "ambe2450":
        want = jax.jit(jambe.decode_ambe2450_parms)(d, _jax_parms(cur), _jax_parms(prev), te)
        got = ambe.decode_ambe2450_parms(torch.from_numpy(d), _port_parms(cur),
                                         _port_parms(prev), torch.from_numpy(te))
    else:
        want = jax.jit(jambe.decode_ambe2400_parms)(d, _jax_parms(cur), _jax_parms(prev))
        got = ambe.decode_ambe2400_parms(torch.from_numpy(d), _port_parms(cur),
                                         _port_parms(prev))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    kinds = set(np.unique(np.asarray(want[2])).tolist())
    assert {0, 2, 7} <= kinds if codec == "ambe2450" else {0, 3} <= kinds
    for part, g, w in (("cur", got[0], want[0]), ("prev", got[1], want[1])):
        _assert_parms(g, w, part, float_tol=5e-5)
        for k in ("w0", "gamma"):
            np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(w, k)),
                                          err_msg=f"{part}.{k}")


# ---------------------------------------------------------------------------
# tones
# ---------------------------------------------------------------------------

def test_tone_fields_match_jax():
    """parse_tone_fields, dstar_tone_id, tone_verified_2450 and
    tone_id_2450 on random ambe_d: exact (integer fields)."""
    d = np.random.default_rng(6).integers(0, 2, (49, 512)).astype(np.int32)
    dt = torch.from_numpy(d)
    for a, b in zip(synth.parse_tone_fields(dt), jax.jit(jsynth.parse_tone_fields)(d)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(synth.dstar_tone_id(dt).numpy(),
                                  np.asarray(jax.jit(jsynth.dstar_tone_id)(d)))
    for a, b in zip(ambe.tone_verified_2450(dt), jax.jit(jambe.tone_verified_2450)(d)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ambe.tone_id_2450(dt).numpy(),
                                  np.asarray(jax.jit(jambe.tone_id_2450)(d)))


def test_render_tone_matches_grid_oracle():
    """render_tone against the numpy per-sample wrapped-phase oracle of
    tests/test_pallas.py (mbelib.c:707-736) for single, dual and invalid
    tone ids and uint32 states above 2^31: samples within 5e-4 of max
    |ref| (f32 phase rounding), the new swn / tonePhase bit-exact."""
    jsynth._lazy_tables()
    rng = np.random.default_rng(3)
    c = 256
    tid = rng.choice(np.r_[np.arange(5, 123), np.arange(128, 164), [0, 1, 255]],
                     size=c).astype(np.int32)
    ad = rng.integers(0, 128, c, dtype=np.int32)
    swn = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    tp = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    assert (swn >= 2**31).any() and (tp >= 2**31).any()

    s_out, swn_out, tp_out = synth.render_tone(
        torch.from_numpy(tid), torch.from_numpy(ad), torch.from_numpy(swn.astype(np.int64)),
        torch.from_numpy(tp.astype(np.int64)))

    steps = np.asarray(jsynth._TONE_STEPS)
    freqs = np.asarray(JT.tone_freqs)
    valid = np.asarray(JT.tone_valid)[tid] != 0
    f1, f2 = freqs[tid, 0], freqs[tid, 1]
    st1, st2 = steps[tid, 0], steps[tid, 1]
    active = valid & (f1 > 0)
    dual = (f2 > 0) & (np.abs(f2 - f1) > 1e-6)
    st2 = np.where(dual, st2, 0).astype(np.uint32)
    gain = (np.maximum(ad, 0) / np.float32(127.0)) * np.float32((32767.0 * 0.95) / 7.0)
    nn = np.arange(1, 161, dtype=np.uint32)[None, :]
    rad = np.float32(2 * np.pi / 2**32)
    s1 = np.sin((swn[:, None] + st1[:, None] * nn).astype(np.float32) * rad
                - np.float32(np.pi / 2))
    s2 = np.sin((tp[:, None] + st2[:, None] * nn).astype(np.float32) * rad
                - np.float32(np.pi / 2))
    ref = np.where(dual[:, None], 0.5 * gain[:, None] * (s1 + s2), gain[:, None] * s1)
    ref = np.where(active[:, None], ref, 0.0)

    np.testing.assert_array_equal(swn_out.numpy(),
                                  np.where(active, swn + st1 * np.uint32(160), swn))
    np.testing.assert_array_equal(tp_out.numpy(),
                                  np.where(active & dual, tp + st2 * np.uint32(160), tp))
    assert np.abs(s_out.numpy().T - ref).max() / np.abs(ref).max() < 5e-4


# ---------------------------------------------------------------------------
# state helpers
# ---------------------------------------------------------------------------

def test_erasure_and_default_parms_match_jax():
    """erasure_parms and the AMBE defaults (constant leaves, made tensors)
    against JAX's erasure_parms and ambe_default_parms_like, leaf for leaf
    (tolerance 0)."""
    rng = np.random.default_rng(9)
    mp, cont = _random_parms(rng, 7), _random_parms(rng, 7)
    mp = dataclasses.replace(mp, errorRate=rng.random(7).astype(np.float32),
                             errorCountTotal=rng.integers(0, 9, 7).astype(np.int32))
    _assert_parms(st.materialize(st.erasure_parms(_port_parms(mp), _port_parms(cont)), 7, "cpu"),
                  jst.erasure_parms(_jax_parms(mp), _jax_parms(cont)), "erasure")
    _assert_parms(st.materialize(st.default_leaves(ambe=True), 7, "cpu"),
                  jst.ambe_default_parms_like(_jax_parms(mp)), "defaults")
    assert st.MUTING_THRESHOLD_AMBE == float(jst.MUTING_THRESHOLD_AMBE)


def test_ambe_state_round_trip():
    """An AMBE state (enh present, swn and tonePhase above 2^31) goes to
    numpy and back leaf for leaf, and a run continued from the round trip
    is identical to the uninterrupted one (fsm_ambe2450's first tone frame,
    t = 3, leaves swn at 2^31)."""
    vec = dict(np.load("tests/vectors/fsm_ambe2450.npz"))
    state = st.init_state(1, rng_seed=np.uint32(vec["seed"]), device="cpu")
    args = (state.cur, state.prev, state.enh, state.comfort_rng, state.lcg_prime)
    zero, no = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.bool)

    def run(args, t0, t1):
        outs = []
        for t in range(t0, t1):
            audio, *args, _ = ambe.process_ambe2450(
                torch.from_numpy(vec["dbits"][t][:, None]),
                torch.tensor([vec["totals"][t]], dtype=torch.int32), zero, no, *args)
            outs.append(audio)
        return args, outs

    args, _ = run(args, 0, 4)
    st_mid = st.ChannelState(*args)
    assert int(st_mid.cur.swn[0]) == 2**31
    np_mid = st.state_to_numpy(st_mid)
    back = st.state_from_numpy(np_mid, "cpu")
    for part in ("cur", "prev", "enh"):
        for k in st.PARMS_FIELDS:
            assert torch.equal(getattr(getattr(back, part), k), getattr(getattr(st_mid, part), k))
    hi = dataclasses.replace(np_mid.cur, swn=np.uint32([0xF0000001]),
                             tonePhase=np.uint32([0x80000000]))
    hi_back = st.state_from_numpy(dataclasses.replace(np_mid, cur=hi), "cpu")
    assert int(hi_back.cur.swn[0]) == 0xF0000001 and int(hi_back.cur.tonePhase[0]) == 2**31
    np.testing.assert_array_equal(st.state_to_numpy(hi_back).cur.swn, hi.swn)
    _, a = run(args, 4, vec["dbits"].shape[0])
    _, b = run((back.cur, back.prev, back.enh, back.comfort_rng, back.lcg_prime), 4,
               vec["dbits"].shape[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tones", [True, False], ids=["tones", "notones"])
@pytest.mark.parametrize("codec", CODECS)
def test_fsm_goldens(vectors, codec, tones):
    """process_ambe2450/2400 on the crafted parameter streams fsm_ambe*
    (tones on) and fsm_notones_ambe* (DISABLE_AMBE_TONES build), with no
    C0 count (c0_valid false, the data path): flags exact, >= 60 dB per
    frame; a tone-play frame with tones off is exact silence."""
    vec = vectors(f"fsm_{codec}" if tones else f"fsm_notones_{codec}")
    state = st.init_state(1, rng_seed=np.uint32(vec["seed"]), device="cpu")
    args = (state.cur, state.prev, state.enh, state.comfort_rng, state.lcg_prime)
    zero, no = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.bool)
    hit, silent_tones = set(), 0
    for t in range(vec["dbits"].shape[0]):
        audio, *args, fsm = PROCESS[codec](
            torch.from_numpy(vec["dbits"][t][:, None]),
            torch.tensor([vec["totals"][t]], dtype=torch.int32), zero, no, *args,
            tones_enabled=tones)
        flags = sum(bit for name, bit in FSM_FLAGS if bool(fsm[name][0]))
        hit |= {name for name, bit in FSM_FLAGS if flags & bit}
        assert flags == int(vec["flags"][t]), f"t={t}: flags {flags:#x}"
        audio = audio[:, 0].numpy()
        if not tones and flags == pipeline.FLAG_TONE and not vec["pcm"][t].any():
            np.testing.assert_array_equal(audio, 0.0)
            silent_tones += 1
        else:
            assert snr_db(vec["pcm"][t], audio) >= 60.0, f"t={t}"
    assert {"repeat", "mute"} <= hit
    if codec == "ambe2450":
        assert {"tone", "erasure"} <= hit
        assert silent_tones >= (0 if tones else 2)


def _run_steps(vec, codec, soft):
    T, C = vec["frames"].shape[:2]
    state = st.init_state(C, rng_seed=vec["seeds"], device="cpu")
    pcm, res, dbits = [], [], []
    for t in range(T):
        state, audio, r, d = pipeline.step(
            codec, torch.from_numpy(vec["frames"][t]), state,
            torch.from_numpy(vec["rel"][t]) if soft else None)
        pcm.append(audio)
        res.append(r)
        dbits.append(d)
    return (torch.stack(pcm), {k: torch.stack([r[k] for r in res]) for k in res[0]},
            torch.stack(dbits))


def _check_golden(vec, pcm, res, dbits=None, soft=False):
    got = np.stack([res[k].numpy() for k in RES_KEYS], axis=-1)
    np.testing.assert_array_equal(got, vec["res"])
    np.testing.assert_array_equal(res["flags"].numpy(), vec["flags"])
    flags = res["flags"].numpy()
    assert ((flags & pipeline.FLAG_SOFT_INPUT) != 0).all() == soft
    assert (flags & pipeline.FLAG_C0_VALID).all() and not (flags & pipeline.FLAG_C4_VALID).any()
    assert (res["status"] == 0).all() and (res["c4_errors"] == 0).all()
    if dbits is not None:
        np.testing.assert_array_equal(dbits.numpy(), vec["dbits"])
    T, C = pcm.shape[:2]
    snrs = np.array([[snr_db(vec["pcm"][t, i], pcm[t, i].numpy()) for i in range(C)]
                     for t in range(T)])
    assert snrs.min() >= 60.0, f"worst frame {snrs.min():.1f} dB"
    s = snr_db(vec["pcm16"].astype(np.float64),
               synth.float_to_short(pcm).numpy().astype(np.float64))
    assert s >= 60.0, f"int16 stream SNR {s:.1f} dB"


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("codec", CODECS)
def test_e2e_goldens(vectors, codec, soft):
    """e2e_ambe2450 / e2e_ambe2400, hard and soft (C=16, T=40), through
    `step` on the CPU."""
    vec = vectors(f"e2e_{codec}_soft" if soft else f"e2e_{codec}")
    pcm, res, dbits = _run_steps(vec, codec, soft)
    _check_golden(vec, pcm, res, dbits, soft)


@pytest.mark.parametrize("codec", CODECS)
def test_long_run_sequence(vectors, codec):
    """long_ambe2450 / long_ambe2400 (C=4, T=200) through `run_sequence`:
    no drift; the int16 stream equals the converted float one."""
    vec = vectors(f"long_{codec}")
    C = vec["frames"].shape[1]
    frames = torch.from_numpy(vec["frames"])
    _, pcm, res = pipeline.run_sequence(
        codec, frames, st.init_state(C, rng_seed=vec["seeds"], device="cpu"))
    _check_golden(vec, pcm, res)
    _, pcm16, _ = pipeline.run_sequence(
        codec, frames, st.init_state(C, rng_seed=vec["seeds"], device="cpu"), int16=True)
    assert torch.equal(pcm16, synth.float_to_short(pcm))


@pytest.mark.parametrize("codec", CODECS)
def test_fsm_frames_goldens(vectors, codec):
    """Crafted tone / silence / erasure / repeat frames behind real ECC
    error counts (C=1) through `step`: flags and counts exact, >= 60 dB."""
    vec = vectors(f"fsm_frames_{codec}")
    state = st.init_state(1, rng_seed=np.uint32(vec["seed"]), device="cpu")
    hit = set()
    for t in range(vec["frames"].shape[0]):
        state, audio, res, _ = pipeline.step(codec, torch.from_numpy(vec["frames"][t][None]),
                                             state)
        flags = int(res["flags"][0])
        assert flags == int(vec["flags"][t]), f"t={t}: flags {flags:#x}"
        np.testing.assert_array_equal([int(res[k][0]) for k in RES_KEYS], vec["res"][t],
                                      err_msg=f"t={t}")
        hit |= {name for name, bit in FSM_FLAGS if flags & bit}
        assert snr_db(vec["pcm"][t], audio[0].numpy()) >= 60.0, f"t={t}"
    assert hit >= ({"tone", "erasure", "repeat", "mute"} if codec == "ambe2450"
                   else {"tone", "repeat", "mute"})


@pytest.mark.parametrize("codec", CODECS)
def test_ambe_needs_carried_enh_and_validates_lanes(vectors, codec):
    """AMBE with carry_enh=False raises; a lane with a non-0/1 bit gives
    silence, status -2, zeroed counts and its state untouched; tones off
    changes nothing on frames that carry no tone."""
    vec = vectors(f"e2e_{codec}")
    frame = torch.from_numpy(vec["frames"][0][:3].copy())
    with pytest.raises(ValueError, match="carry_enh"):
        pipeline.step(codec, frame, st.init_state(3, carry_enh=False, device="cpu"))
    state = st.init_state(3, rng_seed=vec["seeds"][:3], device="cpu")
    _, audio_ref, res_ref, d_ref = pipeline.step(codec, frame, state)
    bad = frame.clone()
    bad[1, 2, 5] = 3
    st_mix, audio_mix, res_mix, d_mix = pipeline.step(codec, bad, state)
    assert res_mix["status"].tolist() == [0, -2, 0]
    assert (audio_mix[1] == 0).all() and (d_mix[1] == 0).all()
    assert all(int(res_mix[k][1]) == 0 for k in RES_KEYS + ("flags",))
    assert torch.equal(audio_mix[[0, 2]], audio_ref[[0, 2]])
    mix, init = st.state_to_numpy(st_mix), st.state_to_numpy(state)
    for part in ("cur", "prev", "enh"):
        for k in st.PARMS_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(mix, part), k)[..., 1],
                                          getattr(getattr(init, part), k)[..., 1])
    if not (res_ref["flags"] & pipeline.FLAG_TONE).any():
        _, audio_nt, _, _ = pipeline.step(codec, frame, state,
                                          config=DecoderConfig(tones_enabled=False))
        assert torch.equal(audio_nt, audio_ref)
