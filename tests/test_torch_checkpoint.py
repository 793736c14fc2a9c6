"""Snapshots of the port's channel state (mbe_tpu_torch.utils.checkpoint)
against the JAX package's (mbe_tpu.utils.checkpoint).

A mid-stream save -> load -> continue reproduces the uninterrupted run
bit for bit; the npz files cross between the two packages with equal
leaves and dtypes; the port continues a JAX snapshot with integers exact
and PCM >= 60 dB per frame against JAX's own continuation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from mbe_tpu import api as japi
from mbe_tpu.models import state as jst
from mbe_tpu.utils import checkpoint as jcheckpoint
from mbe_tpu_torch import api
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

INT_PARMS = ("L", "K", "Vl", "tonePhase", "swn", "amplitudeThreshold",
             "errorCountTotal", "errorCount4", "repeatCount")


def _run(frames, state, start, stop):
    pcm = []
    for t in range(start, stop):
        state, audio, _, _ = api.process_imbe7200x4400_framef(frames[t], state)
        pcm.append(audio)
    return state, pcm


def _assert_states_equal(a, b):
    """Two numpy-leaf states (state_to_numpy or a JAX state): the same
    parts, and every leaf equal with the same dtype."""
    for part in ("cur", "prev", "enh"):
        pa, pb = getattr(a, part), getattr(b, part)
        assert (pa is None) == (pb is None), part
        if pa is None:
            continue
        for k in st.PARMS_FIELDS:
            x, y = np.asarray(getattr(pa, k)), np.asarray(getattr(pb, k))
            assert x.dtype == y.dtype, f"{part}.{k}: {x.dtype} != {y.dtype}"
            np.testing.assert_array_equal(x, y, err_msg=f"{part}.{k}")
    for k in ("comfort_rng", "lcg_prime"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_checkpoint_roundtrip_bitexact(vectors, tmp_path):
    """e2e_imbe7200 (C=16): 3 frames, save, load, 3 more frames equal 6
    uninterrupted frames, PCM and every state leaf (tolerance 0)."""
    vec = vectors("e2e_imbe7200")
    frames = vec["frames"][:6]
    c = frames.shape[1]
    s_ref, pcm_ref = _run(frames, api.init_mbe_parms(c, vec["seeds"], device="cpu"), 0, 6)

    s_mid, pcm_a = _run(frames, api.init_mbe_parms(c, vec["seeds"], device="cpu"), 0, 3)
    path = tmp_path / "snap.npz"
    checkpoint.save(path, s_mid)
    s_fin, pcm_b = _run(frames, checkpoint.load(path, device="cpu"), 3, 6)

    for t, (a, b) in enumerate(zip(pcm_ref, pcm_a + pcm_b)):
        assert torch.equal(a, b), f"frame {t}"
    _assert_states_equal(st.state_to_numpy(s_fin), st.state_to_numpy(s_ref))


def test_checkpoint_slim_imbe_carry(tmp_path):
    """carry_enh=False states (enh is None) round-trip too."""
    s = st.init_state(4, rng_seed=np.arange(4, dtype=np.uint32), carry_enh=False, device="cpu")
    path = tmp_path / "slim.npz"
    checkpoint.save(path, s)
    s2 = checkpoint.load(path, device="cpu")
    assert s2.enh is None and s2.cur.L.device.type == "cpu"
    _assert_states_equal(st.state_to_numpy(s2), st.state_to_numpy(s))


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    path = tmp_path / "s.npz"
    checkpoint.save(path, st.init_state(2, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load(path)


def _uint32_heavy(state):
    """state_to_numpy(state) with the uint32 leaves at the top of their
    range, where an int32 detour would wrap."""
    n = st.state_to_numpy(state)
    c = n.cur.w0.shape[0]
    top = np.full(c, 0xF0000001, np.uint32)
    cur = dataclasses.replace(n.cur, swn=top, tonePhase=top - np.uint32(7))
    return dataclasses.replace(n, cur=cur)


@pytest.mark.parametrize("carry_enh", [True, False], ids=["enh", "noenh"])
def test_snapshots_cross_packages(tmp_path, carry_enh):
    """A port snapshot loads in mbe_tpu.utils.checkpoint.load, and a JAX
    snapshot in the port's load, with equal leaves and dtypes."""
    seeds = np.array([0, 1, 0xFFFFFFFF, 12345], np.uint32)
    ours = st.state_from_numpy(
        _uint32_heavy(st.init_state(4, rng_seed=seeds, carry_enh=carry_enh, device="cpu")),
        "cpu")
    checkpoint.save(tmp_path / "port.npz", ours)
    in_jax = jcheckpoint.load(str(tmp_path / "port.npz"))
    _assert_states_equal(jax.tree.map(np.asarray, in_jax), st.state_to_numpy(ours))

    ref = jst.init_state(4, rng_seed=seeds, carry_enh=carry_enh)
    ref = dataclasses.replace(ref, cur=dataclasses.replace(
        ref.cur, swn=jnp.full(4, 0xF0000001, jnp.uint32),
        tonePhase=jnp.full(4, 0xFFFFFFFF, jnp.uint32)))
    jcheckpoint.save(str(tmp_path / "jax.npz"), ref)
    in_port = checkpoint.load(tmp_path / "jax.npz", device="cpu")
    assert in_port.cur.swn.dtype == torch.int64 and int(in_port.cur.tonePhase[0]) == 0xFFFFFFFF
    _assert_states_equal(st.state_to_numpy(in_port), jax.tree.map(np.asarray, ref))


def test_port_continues_a_jax_snapshot(vectors, tmp_path):
    """fsm_imbe7200 through the Data path: JAX decodes 8 frames and saves;
    the port loads the npz and decodes the other 14 beside JAX's own
    continuation. Flags and integer state exact, PCM and float state
    >= 60 dB per frame."""
    vec = vectors("fsm_imbe7200")
    T = vec["dbits"].shape[0]
    jrun = jax.jit(lambda d, s, te: japi.process_imbe4400_dataf(d, s, te))
    ref = jst.init_state(1, rng_seed=np.uint32(vec["seed"]))
    for t in range(8):
        _, ref, _ = jrun(vec["dbits"][t][None], ref, jnp.asarray([vec["totals"][t]], jnp.int32))
    jcheckpoint.save(str(tmp_path / "jax.npz"), ref)
    ours = checkpoint.load(tmp_path / "jax.npz", device="cpu")
    for t in range(8, T):
        te = np.array([vec["totals"][t]], np.int32)
        audio, ours, fsm = api.process_imbe4400_dataf(vec["dbits"][t][None], ours, te)
        jaudio, ref, jfsm = jrun(vec["dbits"][t][None], ref, jnp.asarray(te))
        for k in ("repeat", "mute", "status"):
            np.testing.assert_array_equal(fsm[k].numpy(), np.asarray(jfsm[k]),
                                          err_msg=f"t={t} {k}")
        assert snr_db(np.asarray(jaudio)[0], audio[0].numpy()) >= 60.0, f"t={t}"
        assert snr_db(vec["pcm"][t], audio[0].numpy()) >= 60.0, f"t={t} vs golden"
        n = st.state_to_numpy(ours)
        for part in ("cur", "prev", "enh"):
            for k in st.PARMS_FIELDS:
                a, b = getattr(getattr(n, part), k), np.asarray(getattr(getattr(ref, part), k))
                if k in INT_PARMS:
                    np.testing.assert_array_equal(a, b, err_msg=f"t={t} {part}.{k}")
                else:
                    assert snr_db(b, a) >= 60.0, f"t={t} {part}.{k}"
        np.testing.assert_array_equal(n.comfort_rng, np.asarray(ref.comfort_rng))
        np.testing.assert_array_equal(n.lcg_prime, np.asarray(ref.lcg_prime))
