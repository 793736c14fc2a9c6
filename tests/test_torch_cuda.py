"""The port on the card: the voiced kernel against its plain version, and
the golden vectors through the pipeline with the kernel in the loop.

Marked `cuda`; without a card every test skips. This file imports
neither jax nor mbe_tpu (nor the jax-importing conftest's helpers), so
on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.ops.cuda import voiced

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parent / "vectors"
RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)


def _snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    p_sig = np.mean(ref ** 2)
    p_err = np.mean((ref - np.asarray(test, np.float64)) ** 2)
    if p_sig < 1e-12:
        return np.inf if p_err < 1e-12 else -np.inf
    return 10.0 * np.log10(p_sig / max(p_err, 1e-30))


def _kernel_inputs(c, device):
    """voiced_sums inputs in the ranges of tests/test_pallas.py."""
    rng = np.random.default_rng(7)

    def u(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=device)

    return [u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
            u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
            u(0, 4, (7, c)), u(-0.02, 0.02, (7, c)), u(0, 6, (7, c)),
            u(0, 2, (7, c)), u(-2e-3, 2e-3, (7, c)), u(0, 1, (160,)), u(0, 1, (160,))]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 1000, 32768])
def test_voiced_kernel_matches_plain(cuda_device, c):
    """Kernel vs plain version at ragged and full widths: max |err| /
    max |ref| < 2e-4 (the recurrence drift bound of the TPU kernel)."""
    args = _kernel_inputs(c, cuda_device)
    before = voiced.LAUNCHES
    out = voiced.voiced_sums(*args)
    torch.cuda.synchronize()
    assert voiced.LAUNCHES == before + 1
    ref = voiced.voiced_sums_reference(*args)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 2e-4


@pytest.mark.cuda
def test_voiced_kernel_rejects_bad_inputs(cuda_device):
    args = _kernel_inputs(64, cuda_device)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        voiced.voiced_sums(*bad)
    bad = list(args)
    bad[1] = torch.empty((64, 56), device=cuda_device).T
    with pytest.raises(ValueError, match="contiguous"):
        voiced.voiced_sums(*bad)


@pytest.mark.cuda
def test_e2e_imbe7200_on_card(cuda_device):
    """e2e_imbe7200 through the port on the card, one kernel launch per
    frame: integers bit-exact, >= 60 dB per frame and for the int16 stream."""
    vec = dict(np.load(VECTORS / "e2e_imbe7200.npz"))
    T, C = vec["frames"].shape[:2]
    state = st.init_state(C, rng_seed=vec["seeds"], device=cuda_device)
    frames = torch.as_tensor(vec["frames"], device=cuda_device)
    before = voiced.LAUNCHES
    pcm16 = []
    for t in range(T):
        state, audio, res, d = pipeline.step("imbe7200", frames[t], state)
        np.testing.assert_array_equal(d.cpu().numpy(), vec["dbits"][t])
        got = np.stack([res[k].cpu().numpy() for k in RES_KEYS], axis=1)
        np.testing.assert_array_equal(got, vec["res"][t])
        np.testing.assert_array_equal(res["flags"].cpu().numpy(), vec["flags"][t])
        for i in range(C):
            assert _snr_db(vec["pcm"][t, i], audio[i].cpu().numpy()) >= 60.0, (t, i)
        pcm16.append(synth.float_to_short(audio).cpu().numpy())
    assert voiced.LAUNCHES - before == T
    assert _snr_db(vec["pcm16"], np.stack(pcm16)) >= 60.0
