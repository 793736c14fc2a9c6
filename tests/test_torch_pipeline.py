"""The port's main path (mbe_tpu_torch.pipeline, hard IMBE 7200x4400)
against the reference golden vectors and the JAX pipeline.

Integers (imbe_d bits, error counts, flags, integer state) bit-exact;
PCM >= 60 dB SNR per frame and lane, the bar tests/test_e2e.py sets."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import snr_db
from mbe_tpu import pipeline as jpipeline
from mbe_tpu.models import state as jst
from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")
INT_PARMS = ("L", "K", "Vl", "tonePhase", "swn", "amplitudeThreshold",
             "errorCountTotal", "errorCount4", "repeatCount")


def _check_e2e(vec, device, carry_enh=True):
    T, C = vec["frames"].shape[:2]
    state = st.init_state(C, rng_seed=vec["seeds"], carry_enh=carry_enh, device=device)
    frames = torch.as_tensor(vec["frames"], device=device)
    pcm16 = []
    for t in range(T):
        state, audio, res, d = pipeline.step("imbe7200", frames[t], state)
        assert (state.enh is None) == (not carry_enh)
        np.testing.assert_array_equal(d.cpu().numpy(), vec["dbits"][t], err_msg=f"t={t}")
        got = np.stack([res[k].cpu().numpy() for k in RES_KEYS], axis=1)
        np.testing.assert_array_equal(got, vec["res"][t], err_msg=f"t={t}")
        np.testing.assert_array_equal(res["flags"].cpu().numpy(), vec["flags"][t],
                                      err_msg=f"t={t} flags")
        assert (res["status"] == 0).all()
        audio = audio.cpu().numpy()
        for i in range(C):
            s = snr_db(vec["pcm"][t, i], audio[i])
            assert s >= 60.0, f"t={t} lane={i}: SNR {s:.1f} dB"
        pcm16.append(synth.float_to_short(torch.from_numpy(audio)).numpy())
    s = snr_db(vec["pcm16"].astype(np.float64), np.stack(pcm16).astype(np.float64))
    assert s >= 60.0, f"int16 sequence SNR {s:.1f} dB"


@pytest.mark.parametrize("carry_enh", [True, False], ids=["enh", "noenh"])
def test_e2e_imbe7200_matches_reference(vectors, carry_enh):
    """e2e_imbe7200 (C=16, T=40) through `step`; with carry_enh=False the
    incoming cur stands in for the dropped enh copy, with equal output."""
    _check_e2e(vectors("e2e_imbe7200"), "cpu", carry_enh)


def test_long_imbe7200_run_sequence(vectors):
    """long_imbe7200 (C=4, T=200) through `run_sequence`: no drift."""
    vec = vectors("long_imbe7200")
    T, C = vec["frames"].shape[:2]
    state = st.init_state(C, rng_seed=vec["seeds"], device="cpu")
    state, pcm, res = pipeline.run_sequence("imbe7200", torch.from_numpy(vec["frames"]),
                                            state)
    np.testing.assert_array_equal(res["flags"].numpy(), vec["flags"])
    got = np.stack([res[k].numpy() for k in RES_KEYS], axis=-1)
    np.testing.assert_array_equal(got, vec["res"])
    pcm = pcm.numpy()
    snrs = np.array([[snr_db(vec["pcm"][t, i], pcm[t, i]) for i in range(C)]
                     for t in range(T)])
    assert snrs.min() >= 60.0, f"worst frame {snrs.min():.1f} dB"
    _, pcm16, _ = pipeline.run_sequence(
        "imbe7200", torch.from_numpy(vec["frames"]),
        st.init_state(C, rng_seed=vec["seeds"], device="cpu"), int16=True)
    assert pcm16.dtype == torch.int16
    s = snr_db(vec["pcm16"].astype(np.float64), pcm16.numpy().astype(np.float64))
    assert s >= 60.0, f"int16 sequence SNR {s:.1f} dB"


def test_fsm_frames_imbe7200(vectors):
    """Crafted repeat/mute frames behind real ECC error counts (C=1)."""
    vec = vectors("fsm_frames_imbe7200")
    state = st.init_state(1, rng_seed=np.uint32(vec["seed"]), device="cpu")
    hit = set()
    for t in range(vec["frames"].shape[0]):
        state, audio, res, _ = pipeline.step(
            "imbe7200", torch.from_numpy(vec["frames"][t][None]), state)
        flags = int(res["flags"][0])
        assert flags == int(vec["flags"][t]), f"t={t}: flags {flags:#x}"
        np.testing.assert_array_equal([int(res[k][0]) for k in RES_KEYS], vec["res"][t],
                                      err_msg=f"t={t}")
        hit |= {n for n, b in (("repeat", pipeline.FLAG_REPEAT),
                               ("mute", pipeline.FLAG_MUTE)) if flags & b}
        s = snr_db(vec["pcm"][t], audio[0].numpy())
        assert s >= 60.0, f"t={t}: SNR {s:.1f} dB"
    assert hit == {"repeat", "mute"}


def test_invalid_lane_rollback(vectors):
    """A lane with a non-0/1 bit: silence, status -2, zeroed counts and
    its state untouched; the valid lane is bit-identical to a clean run."""
    vec = vectors("e2e_imbe7200")
    frame = torch.from_numpy(vec["frames"][0][:2].copy())
    state = st.init_state(2, rng_seed=vec["seeds"][:2], device="cpu")
    st_ref, audio_ref, res_ref, _ = pipeline.step("imbe7200", frame, state)
    bad = frame.clone()
    bad[1, 2, 5] = 200
    st_mix, audio_mix, res_mix, d_mix = pipeline.step("imbe7200", bad, state)

    assert torch.equal(audio_mix[0], audio_ref[0])
    assert (audio_mix[1] == 0).all() and (d_mix[1] == 0).all()
    assert res_mix["status"].tolist() == [0, -2]
    assert all(int(res_mix[k][1]) == 0 for k in RES_KEYS + ("flags",))
    st_np, ref_np = st.state_to_numpy(st_mix), st.state_to_numpy(st_ref)
    init_np = st.state_to_numpy(state)
    for part in ("cur", "prev", "enh"):
        for k in st.PARMS_FIELDS:
            a = getattr(getattr(st_np, part), k)
            np.testing.assert_array_equal(a[..., 1], getattr(getattr(init_np, part), k)[..., 1])
            np.testing.assert_array_equal(a[..., 0], getattr(getattr(ref_np, part), k)[..., 0])
    np.testing.assert_array_equal(st_np.comfort_rng[:, 1], init_np.comfort_rng[:, 1])


def _to_jax_state(np_state):
    """The port's numpy-leaf state -> a JAX ChannelState."""
    def parms(p):
        return jst.Parms(**dataclasses.asdict(p))
    return jst.ChannelState(cur=parms(np_state.cur), prev=parms(np_state.prev),
                            enh=None if np_state.enh is None else parms(np_state.enh),
                            comfort_rng=np_state.comfort_rng, lcg_prime=np_state.lcg_prime)


def test_matches_jax_from_midstream_state(vectors):
    """JAX runs 3 frames; its state goes to the port by state_from_numpy;
    then 5 frames through both. Outputs and integer state exact, PCM and
    float state to >= 60 dB."""
    vec = vectors("e2e_imbe7200")
    frames = vec["frames"]
    codec = "imbe7200"
    jstep = jax.jit(lambda fr, sr, s: jpipeline.step(codec, fr, s, sr))
    jstate = jst.init_state(frames.shape[1], rng_seed=vec["seeds"])
    for t in range(3):
        jstate, *_ = jstep(frames[t], None, jstate)
    state = st.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for t in range(3, 8):
        jstate, jaudio, jres, jd = jstep(frames[t], None, jstate)
        state, audio, res, d = pipeline.step(codec, torch.from_numpy(frames[t]), state)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        for k in RES_KEYS + ("flags", "status"):
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]), err_msg=k)
        jaudio = np.asarray(jaudio)
        for i in range(frames.shape[1]):
            assert snr_db(jaudio[i], audio[i].numpy()) >= 60.0, f"t={t} lane={i}"
        ours = st.state_to_numpy(state)
        for part in ("cur", "prev", "enh"):
            for k in st.PARMS_FIELDS:
                a = getattr(getattr(ours, part), k)
                b = np.asarray(getattr(getattr(jstate, part), k))
                if k in INT_PARMS:
                    np.testing.assert_array_equal(a, b, err_msg=f"t={t} {part}.{k}")
                else:
                    assert snr_db(b, a) >= 60.0, f"t={t} {part}.{k}"
        np.testing.assert_array_equal(ours.comfort_rng, np.asarray(jstate.comfort_rng))
        np.testing.assert_array_equal(ours.lcg_prime, np.asarray(jstate.lcg_prime))
    # the round trip back to JAX is leaf for leaf
    back = _to_jax_state(st.state_to_numpy(state))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)


def test_step_int16_and_unported_paths(vectors):
    vec = vectors("e2e_imbe7200")
    frame = torch.from_numpy(vec["frames"][0])
    state = st.init_state(16, rng_seed=vec["seeds"], device="cpu")
    _, audio, _, _ = pipeline.step("imbe7200", frame, state)
    _, pcm16, _, _ = pipeline.step_int16("imbe7200", frame, state)
    assert pcm16.dtype == torch.int16
    assert torch.equal(pcm16, synth.float_to_short(audio))
    # trusted input: skipping the lane validation changes nothing on 0/1 bits
    _, audio_nv, res_nv, _ = pipeline.step(
        "imbe7200", frame, state, config=DecoderConfig(validate_lanes=False))
    assert torch.equal(audio_nv, audio) and (res_nv["status"] == 0).all()
    _, seq16, _ = pipeline.run_sequence("imbe7200", frame[None], state,
                                        config=DecoderConfig(int16_output=True))
    assert torch.equal(seq16[0], pcm16)
    # the AMBE codecs are ported: a [C, 4, 24] frame runs with a carried
    # enh state and raises without one
    for codec in ("ambe2450", "ambe2400"):
        ambe_frame = torch.from_numpy(vectors(f"e2e_{codec}")["frames"][0])
        _, a, r, d = pipeline.step(codec, ambe_frame,
                                   st.init_state(16, carry_enh=True, device="cpu"))
        assert a.shape == (16, 160) and d.shape == (16, 49) and (r["status"] == 0).all()
        with pytest.raises(ValueError, match="carry_enh"):
            pipeline.step(codec, ambe_frame, st.init_state(16, carry_enh=False, device="cpu"))
    # soft input at full reliability runs the soft path and flags it
    _, _, res_soft, _ = pipeline.step("imbe7200", frame, state,
                                      soft_rel=torch.full_like(frame, 255))
    assert (res_soft["flags"] & pipeline.FLAG_SOFT_INPUT).all()
    with pytest.raises(ValueError):
        pipeline.step("imbe9999", frame, state)
