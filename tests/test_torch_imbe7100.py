"""Soft-decision IMBE 7200x4400 and hard/soft IMBE 7100x4400 through the
port (mbe_tpu_torch), against the JAX package and the golden vectors.

Integers (imbe_d bits, packed words, error counts, flags) bit-exact; PCM
>= 60 dB SNR per frame and lane and for the int16 stream, the bar
tests/test_e2e.py sets."""

import jax
import numpy as np
import pytest
import torch

from conftest import snr_db
from mbe_tpu.models import imbe as jimbe
from mbe_tpu.tables import T as JT
from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import imbe
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.ops.cuda import softecc

torch.set_num_threads(1)

RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")
SHAPES = {"imbe7200": (8, 23), "imbe7100": (7, 24)}
U32 = 0xFFFFFFFF  # the JAX words are int32, the port's int64


def _b0_planes_7100(b0):
    """[88, N] 7100-layout imbe_d with b0 at d[1..6], d[86..87] (MSB first)
    and random bits elsewhere."""
    rng = np.random.default_rng(11)
    d = rng.integers(0, 2, (88, len(b0))).astype(np.int32)
    for j, pos in enumerate((1, 2, 3, 4, 5, 6, 86, 87)):
        d[pos] = (b0 >> (7 - j)) & 1
    return d


def test_convert_7100_to_7200_every_K():
    """The bit-plane and packed 7100 -> 7200 conversions against JAX, for
    every b0 (so every K the b0 table gives, 3..12, and the clamped
    b0 > 207); the per-K tables equal JAX's for all K = 1..12."""
    np.testing.assert_array_equal(imbe._conv7100_tables(), jimbe._conv7100_tables())
    sw, sb = jimbe._conv7100_packed_tables()
    src = imbe._conv7100_packed_src(torch.device("cpu")).numpy()[1:]
    np.testing.assert_array_equal(src, 32 * sw.astype(np.int64) + sb.astype(np.int64))
    b0 = np.repeat(np.arange(256), 2)
    assert set(np.asarray(JT.imbe_K_by_b0)[np.minimum(b0, 207)]) == set(range(3, 13))
    d71 = _b0_planes_7100(b0)
    got = imbe.convert_7100_to_7200(torch.from_numpy(d71)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jimbe.convert_7100_to_7200)(d71)))
    w71 = imbe._pack_fields(torch.from_numpy(d71), imbe._FIELDS_7100)
    jw71 = tuple(np.asarray(w & U32).astype(np.uint32).view(np.int32) for w in w71)
    want = jax.jit(jimbe.convert_7100_to_7200_packed)(jw71)
    for a, b in zip(imbe.convert_7100_to_7200_packed(w71), want):
        np.testing.assert_array_equal(a.numpy() & U32, np.asarray(b).astype(np.int64) & U32)
    np.testing.assert_array_equal(
        imbe.expand_imbe_d(imbe.convert_7100_to_7200_packed(w71)).numpy(), got)


@pytest.mark.parametrize("codec,soft", [("imbe7200", True), ("imbe7100", False),
                                        ("imbe7100", True)],
                         ids=["imbe7200_soft", "imbe7100_hard", "imbe7100_soft"])
def test_frame_decode_vs_jax(codec, soft):
    """decode_imbe7200_frame(frame, soft_rel) and decode_imbe7100_frame
    (hard and soft) against JAX on seeded random frames: imbe_d and the
    error counts bit-exact; the words are the packed imbe_d. A quarter of
    the lanes carry constant reliabilities, where the tie-break decides."""
    rng = np.random.default_rng(3)
    c = 96
    f = rng.integers(0, 2, (c, *SHAPES[codec])).astype(np.int32)
    rel = rng.integers(0, 256, f.shape).astype(np.int32)
    rel[: c // 8] = 0
    rel[c // 8: c // 4] = 7
    jfn = jimbe.decode_imbe7200_frame if codec == "imbe7200" else jimbe.decode_imbe7100_frame
    fn = imbe.decode_imbe7200_frame if codec == "imbe7200" else imbe.decode_imbe7100_frame
    want = jax.jit(jfn)(f, rel) if soft else jax.jit(jfn)(f)
    d, c0, prot, c4, words = fn(torch.from_numpy(f), torch.from_numpy(rel) if soft else None)
    for got, ref in zip((d, c0, prot, c4), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for a, b in zip(imbe.pack_imbe_words(d), words):
        assert torch.equal(a, b)


def _run_steps(vec, codec, soft, rel=None):
    T, C = vec["frames"].shape[:2]
    state = st.init_state(C, rng_seed=vec["seeds"], device="cpu")
    frames = torch.from_numpy(vec["frames"])
    rel = torch.from_numpy(vec["rel"]) if soft and rel is None else rel
    pcm, res, dbits = [], [], []
    for t in range(T):
        state, audio, r, d = pipeline.step(codec, frames[t], state,
                                           None if rel is None else rel[t])
        pcm.append(audio)
        res.append(r)
        dbits.append(d)
    return (torch.stack(pcm), {k: torch.stack([r[k] for r in res]) for k in res[0]},
            torch.stack(dbits))


def _check_golden(vec, pcm, res, dbits=None, soft=False):
    got = np.stack([res[k].numpy() for k in RES_KEYS], axis=-1)
    np.testing.assert_array_equal(got, vec["res"])
    np.testing.assert_array_equal(res["flags"].numpy(), vec["flags"])
    assert ((res["flags"].numpy() & pipeline.FLAG_SOFT_INPUT) != 0).all() == soft
    assert (res["status"] == 0).all()
    if dbits is not None:
        np.testing.assert_array_equal(dbits.numpy(), vec["dbits"])
    T, C = pcm.shape[:2]
    snrs = np.array([[snr_db(vec["pcm"][t, i], pcm[t, i].numpy()) for i in range(C)]
                     for t in range(T)])
    assert snrs.min() >= 60.0, f"worst frame {snrs.min():.1f} dB"
    s = snr_db(vec["pcm16"].astype(np.float64),
               synth.float_to_short(pcm).numpy().astype(np.float64))
    assert s >= 60.0, f"int16 stream SNR {s:.1f} dB"


@pytest.mark.parametrize("name,codec,soft", [
    ("e2e_imbe7200_soft", "imbe7200", True),
    ("e2e_imbe7100", "imbe7100", False),
    ("e2e_imbe7100_soft", "imbe7100", True)])
def test_e2e_goldens(vectors, name, codec, soft):
    """The C=16, T=40 goldens through `step` on the CPU."""
    vec = vectors(name)
    pcm, res, dbits = _run_steps(vec, codec, soft)
    _check_golden(vec, pcm, res, dbits, soft)


def test_long_imbe7100_run_sequence(vectors):
    """long_imbe7100 (C=4, T=200) through `run_sequence`: no drift."""
    vec = vectors("long_imbe7100")
    C = vec["frames"].shape[1]
    state = st.init_state(C, rng_seed=vec["seeds"], device="cpu")
    _, pcm, res = pipeline.run_sequence("imbe7100", torch.from_numpy(vec["frames"]), state)
    _check_golden(vec, pcm, res)
    _, pcm16, _ = pipeline.run_sequence(
        "imbe7100", torch.from_numpy(vec["frames"]),
        st.init_state(C, rng_seed=vec["seeds"], device="cpu"), int16=True)
    assert torch.equal(pcm16, synth.float_to_short(pcm))


def test_fsm_frames_imbe7100(vectors):
    """Crafted repeat/mute 7100 frames behind real ECC error counts (C=1)."""
    vec = vectors("fsm_frames_imbe7100")
    state = st.init_state(1, rng_seed=np.uint32(vec["seed"]), device="cpu")
    hit = set()
    for t in range(vec["frames"].shape[0]):
        state, audio, res, _ = pipeline.step(
            "imbe7100", torch.from_numpy(vec["frames"][t][None]), state)
        flags = int(res["flags"][0])
        assert flags == int(vec["flags"][t]), f"t={t}: flags {flags:#x}"
        np.testing.assert_array_equal([int(res[k][0]) for k in RES_KEYS], vec["res"][t],
                                      err_msg=f"t={t}")
        hit |= {n for n, b in (("repeat", pipeline.FLAG_REPEAT),
                               ("mute", pipeline.FLAG_MUTE)) if flags & b}
        assert snr_db(vec["pcm"][t], audio[0].numpy()) >= 60.0, f"t={t}"
    assert hit == {"repeat", "mute"}


@pytest.mark.parametrize("codec", ["imbe7200", "imbe7100"])
def test_soft_lane_validation_and_clamp(vectors, codec):
    """Soft input: a lane with a non-0/1 bit gives status -2, silence,
    zeroed counts and its state untouched; reliabilities outside 0..255
    are clamped (jnp.clip in mbe_tpu.pipeline.step), and uint8 ones are
    taken as they are."""
    vec = vectors(f"e2e_{codec}_soft")
    frame = torch.from_numpy(vec["frames"][0][:4].copy())
    rel = torch.from_numpy(vec["rel"][0][:4].copy())
    state = st.init_state(4, rng_seed=vec["seeds"][:4], device="cpu")
    st_ref, audio_ref, res_ref, d_ref = pipeline.step(codec, frame, state, rel)

    wild = rel.clone()
    wild[:, 0, :6] = torch.where(wild[:, 0, :6] > 128, 999, -7)
    clamped = torch.clamp(wild, 0, 255)
    out_wild = pipeline.step(codec, frame, state, wild)
    out_clamped = pipeline.step(codec, frame, state, clamped)
    out_u8 = pipeline.step(codec, frame, state, clamped.to(torch.uint8))
    for other in (out_wild, out_u8):
        assert torch.equal(other[1], out_clamped[1]) and torch.equal(other[3], out_clamped[3])
        for k in RES_KEYS + ("flags",):
            assert torch.equal(other[2][k], out_clamped[2][k])

    bad = frame.clone()
    bad[2, 3, 4] = 7
    st_mix, audio_mix, res_mix, d_mix = pipeline.step(codec, bad, state, rel)
    assert res_mix["status"].tolist() == [0, 0, -2, 0]
    assert (audio_mix[2] == 0).all() and (d_mix[2] == 0).all()
    assert all(int(res_mix[k][2]) == 0 for k in RES_KEYS + ("flags",))
    keep = [0, 1, 3]
    assert torch.equal(audio_mix[keep], audio_ref[keep]) and torch.equal(d_mix[keep], d_ref[keep])
    mix, init = st.state_to_numpy(st_mix), st.state_to_numpy(state)
    for part in ("cur", "prev", "enh"):
        for k in st.PARMS_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(mix, part), k)[..., 2],
                                          getattr(getattr(init, part), k)[..., 2])


def test_soft_step_runs_three_soft_decodes():
    """One soft step decodes through the soft decode (its plain form,
    soft_decode_keys_reference, on the CPU) three times (C0, the data
    Golay blocks, the Hamming blocks), for both codecs."""
    calls = []
    real = softecc.soft_decode_keys_reference

    def counting(bits, rel, idx_hard, code):
        calls.append((code, tuple(bits.shape)))
        return real(bits, rel, idx_hard, code)

    softecc.soft_decode_keys_reference = counting
    try:
        for codec, rows in (("imbe7200", 8), ("imbe7100", 7)):
            shape = (5, rows, 23 if codec == "imbe7200" else 24)
            pipeline.step(codec, torch.zeros(shape, dtype=torch.int32),
                          st.init_state(5, device="cpu"), torch.full(shape, 100))
    finally:
        softecc.soft_decode_keys_reference = real
    assert calls == [("golay", (5, 23)), ("golay", (15, 23)), ("hamstd", (15, 15)),
                     ("golay", (5, 23)), ("golay", (15, 23)), ("ham7100", (10, 15))]
