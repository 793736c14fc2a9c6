"""Port noise generators and synthesis (mbe_tpu_torch) against big-int
oracles, libm and the JAX package. On the CPU the voiced bank runs its
plain version; tests/test_torch_cuda.py holds the kernel on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbe_tpu.models import speech as jspeech
from mbe_tpu.models import state as jst
from mbe_tpu.ops import synth as jsynth
from mbe_tpu.ops.pallas import voiced as jvoiced
from mbe_tpu_torch.models import speech
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import noise, synth
from mbe_tpu_torch.ops.cuda import voiced

torch.set_num_threads(1)


def test_lcg_block_exact():
    st = np.random.default_rng(0).integers(0, 53125, 64)
    samp, nxt = noise.lcg_block(torch.from_numpy(st), 160)
    for i in range(64):
        s = int(st[i])
        for k in range(160):
            assert samp[k, i] == s
            s = (171 * s + 11213) % 53125
        assert nxt[i] == s


def test_java_random_exact():
    """comfort_noise vs the 48-bit big-int Java Random, across seeds
    whose limbs exercise every carry (seed 0 maps to 0x6D25357B)."""
    m48 = (1 << 48) - 1
    seeds = [12345, 0, 0xFFFFFFFF, 0x6D25357B]
    limbs = noise.java_random_init(torch.tensor(seeds, dtype=torch.int64))
    state = [((s or 0x6D25357B) ^ 0x5DEECE66D) & m48 for s in seeds]
    gain = np.float32((0.003 * 32767.0) / 7.0)
    for _ in range(2):  # the second frame starts from the returned limbs
        samp, limbs = noise.comfort_noise(limbs)
        for i in range(len(seeds)):
            for k in range(160):
                state[i] = (state[i] * 0x5DEECE66D + 0xB) & m48
                u = (np.float32(state[i] >> 24) / np.float32(16777216.0)) \
                    * np.float32(2.0) - np.float32(1.0)
                assert samp[k, i].item() == np.float32(u * gain)
            assert sum(int(limbs[j, i]) << (16 * j) for j in range(3)) == state[i]


def test_noise_cold_start_and_overlap():
    """Cold start emits zeros and primes the seed; a warm frame's overlap
    is samples 64..159 of the previous seed (mbe_unvoiced_fft.c:311-338)."""
    seed = torch.tensor([-1.0, -1.0, 100.0, 0.0])
    prev_seed = torch.tensor([-1.0, -1.0, 200.0, -1.0])
    prime = torch.tensor([3147.0, 555.0, 3147.0, 3147.0])
    buf, new_seed, new_ps = noise.generate_noise_with_overlap(seed, prev_seed, prime)
    assert (buf[:, 0] == 0).all() and new_ps[0] == -1.0
    assert new_seed[0] == 3147.0 and new_seed[1] == 555.0
    s = 200
    for _ in range(64):
        s = (171 * s + 11213) % 53125
    for j in range(96):
        assert buf[j, 2] == s
        s = (171 * s + 11213) % 53125
    assert buf[96, 2] == 100.0 and new_ps[2] == 100.0
    assert (buf[:96, 3] == 0).all() and buf[97, 3] == 11213.0
    b2, _, _ = noise.generate_noise_with_overlap(new_seed, new_ps, prime)
    np.testing.assert_array_equal(buf[160:, 2].numpy(), b2[:96, 2].numpy())


def test_fmodf_2pi_exact_vs_libm():
    rng = np.random.default_rng(42)
    two_pi = np.float32(2 * np.pi)
    x = np.concatenate([
        rng.uniform(0.0, 4096.0, 20000).astype(np.float32),
        two_pi * np.arange(660, dtype=np.float32),
        np.nextafter(two_pi * np.arange(1, 660, dtype=np.float32), np.float32(0.0)),
        np.array([0.0, 1e-30, 6.2831855, 6.2831850], np.float32)])
    got = synth.fmodf_2pi(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.fmod(x, two_pi))


def test_float_to_short_special_values():
    x = torch.tensor([[np.nan, np.inf, -np.inf, 1.0, -1.0, 1e9, -1e9, 0.4]])
    clip = int(np.float32(32767.0 * 0.95))
    assert synth.float_to_short(x)[0].tolist() == [0, clip, -clip, 7, -7, clip, -clip, 2]
    out = synth.clip_float(torch.tensor([1e6, -1e6, 10.0]))
    assert out.tolist() == [synth.SOFT_CLIP, -synth.SOFT_CLIP, 10.0]


def test_unvoiced_fft_matches_jax():
    """Band energies by scatter-add, gains back by gather, DFT matmuls:
    <= 1e-4 relative to the JAX XLA stage (sum order differs)."""
    rng = np.random.default_rng(5)
    c = 128
    L = rng.integers(9, 57, c).astype(np.int32)
    args = (
        (2.0 * np.pi * 0.4875 / (L + 0.25)).astype(np.float32), L,
        rng.uniform(0, 500, (57, c)).astype(np.float32),
        rng.integers(0, 2, (57, c)).astype(np.int32),
        rng.uniform(-400, 400, (128, c)).astype(np.float32),
        rng.uniform(0, 53125, (256, c)).astype(np.float32))
    add_ref, uw_ref = (np.asarray(x) for x in jax.jit(jsynth.unvoiced_fft)(*args))
    add, uw = (x.numpy() for x in synth.unvoiced_fft(*map(torch.from_numpy, args)))
    scale = max(np.abs(add_ref).max(), np.abs(uw_ref).max())
    assert np.abs(add - add_ref).max() / scale < 1e-4
    assert np.abs(uw - uw_ref).max() / scale < 1e-4
    band = synth.band_of_bins(torch.from_numpy(args[0])).numpy()
    np.testing.assert_array_equal(band, np.asarray(jsynth.band_of_bins(args[0])))


def test_should_mute_and_rm0_match_jax():
    """mbe_should_mute_speech and mbe_current_frame_rm0 on random lanes,
    exactly as the JAX package (the same f32 compares and masked sums)."""
    import dataclasses
    rng = np.random.default_rng(2)
    c = 64
    p = jax.tree.map(np.asarray, jst.init_state(c)).cur
    p = dataclasses.replace(
        p, L=rng.integers(0, 60, c).astype(np.int32),
        Ml=rng.uniform(0, 3, (57, c)).astype(np.float32),
        repeatCount=rng.integers(0, 6, c).astype(np.int32),
        errorRate=rng.uniform(0, 0.2, c).astype(np.float32),
        mutingThreshold=np.where(rng.random(c) < 0.5, np.float32(0.096),
                                 np.float32(0.0875)).astype(np.float32))
    ours = st.state_from_numpy(jst.ChannelState(p, p, None, np.zeros((3, c), np.uint32),
                                                np.zeros(c, np.float32)), "cpu").cur
    np.testing.assert_array_equal(speech.should_mute(ours).numpy(),
                                  np.asarray(jspeech.should_mute(p)))
    np.testing.assert_allclose(speech.current_frame_rm0(ours).numpy(),
                               np.asarray(jspeech.current_frame_rm0(p)), rtol=1e-6)


def _render_args(c, seed):
    """render_voiced inputs; half the lanes pitch-stable so the
    interpolated path (l < 8, both voiced, |dw0| < 0.1*w0) is taken."""
    rng = np.random.default_rng(seed)
    cw0 = (0.05 + rng.random(c) * 0.25).astype(np.float32)
    pw0 = cw0 * np.where(rng.random(c) < 0.5, 1.01, 1.5).astype(np.float32)
    return (cw0, (rng.random((57, c)) * 2).astype(np.float32),
            (rng.random((57, c)) < 0.7).astype(np.int32),
            (rng.random((57, c)) * 6.28).astype(np.float32),
            pw0, (rng.random((57, c)) * 2).astype(np.float32),
            (rng.random((57, c)) < 0.7).astype(np.int32),
            (rng.random((57, c)) * 6.28).astype(np.float32),
            rng.integers(9, 57, c, dtype=np.int32))


def test_render_voiced_matches_jax_xla(monkeypatch):
    """The port's wiring (plain version on CPU) vs the JAX closed-form
    XLA path: 5e-4 relative, the bound test_pallas.py sets for the same
    wiring (start-phase shift and amp-lerp reassociation)."""
    monkeypatch.setenv("MBE_TPU_PALLAS_VOICED", "0")
    args = _render_args(128, 11)
    ref = np.asarray(jax.jit(jsynth.render_voiced)(*args))
    out = synth.render_voiced(*map(torch.from_numpy, args)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 5e-4


def _kernel_inputs(c, seed):
    """voiced_sums inputs in the ranges of tests/test_pallas.py."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return ([u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
             u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
             u(0, 4, (7, c)), u(-0.02, 0.02, (7, c)), u(0, 6, (7, c)),
             u(0, 2, (7, c)), u(-2e-3, 2e-3, (7, c))],
            [u(0, 1, 160), u(0, 1, 160)])


def _oracle(bank, win):
    """The numpy closed form of tests/test_pallas.py (float64), [160, C]."""
    g1, p1, s1, g2, p2, s2, a0, da, ip, al, q = (x.astype(np.float64) for x in bank)
    n = np.arange(160)[None, :, None]
    ref_p = np.sum(g1[:, None] * np.cos(p1[:, None] + s1[:, None] * n), axis=0)
    ref_c = np.sum(g2[:, None] * np.cos(p2[:, None] + s2[:, None] * n), axis=0)
    ref_i = np.sum((a0[:, None] + da[:, None] * n)
                   * np.cos(ip[:, None] + al[:, None] * n + q[:, None] * n * n), axis=0)
    return win[0][:, None] * ref_p + win[1][:, None] * ref_c + ref_i


def test_voiced_reference_matches_pallas_kernel():
    """Plain version vs the JAX Pallas kernel (interpret mode) at C=128:
    2e-4 relative, the Chebyshev recurrence's drift bound."""
    bank, win = _kernel_inputs(128, 7)
    ref = np.asarray(jvoiced.voiced_sums(*map(jnp.asarray, bank + win), interpret=True))
    out = voiced.voiced_sums_reference(*map(torch.from_numpy, bank + win)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 2e-4


@pytest.mark.parametrize("c", [16, 200])
def test_voiced_reference_matches_oracle_ragged(c):
    """Channel counts that are no multiple of 128 (the kernel masks the
    tail): plain version vs the float64 oracle at 1e-5 relative (float32
    phase rounding at arguments up to ~500 rad)."""
    bank, win = _kernel_inputs(c, c)
    out = voiced.voiced_sums(*map(torch.from_numpy, bank + win)).numpy()
    ref = _oracle(bank, win)
    assert out.shape == (160, c)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_voiced_sums_dispatch_by_device():
    """CPU tensors take the plain version (no launch counted); a device
    with no kernel raises instead of falling back."""
    bank, win = _kernel_inputs(16, 3)
    before = voiced.LAUNCHES
    voiced.voiced_sums(*map(torch.from_numpy, bank + win))
    assert voiced.LAUNCHES == before
    meta = [torch.from_numpy(x).to("meta") for x in bank + win]
    with pytest.raises(ValueError, match="no kernel"):
        voiced.voiced_sums(*meta)
