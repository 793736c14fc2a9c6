"""The frozen reference reproduces the repository's goldens: integers
exact, and at least 60 dB per frame (the repository's own bar)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import pipeline as ref
from portbench.reference import runner
from portbench.reference.models.state import init_state
from portbench.reference.ops.synth import float_to_short

VECTORS = Path(__file__).resolve().parents[2] / "tests" / "vectors"
SNR_MIN_DB = 60.0


def snr_db(want, got):
    want = np.asarray(want, np.float64)
    err = want - np.asarray(got, np.float64)
    p_sig, p_err = np.mean(want ** 2), np.mean(err ** 2)
    if p_sig < 1e-12:
        return np.inf if p_err < 1e-12 else -np.inf
    return 10.0 * np.log10(p_sig / max(p_err, 1e-30))


def load(name):
    with np.load(VECTORS / f"{name}.npz") as z:
        return {k: z[k] for k in z}


@pytest.mark.parametrize("name,codec", [("e2e_imbe7200", "imbe7200"),
                                        ("e2e_ambe2450_soft", "ambe2450")])
def test_reference_reproduces_golden(name, codec):
    vec = load(name)
    rel = vec.get("rel")
    state = init_state(vec["frames"].shape[1], vec["seeds"], carry_enh=codec.startswith("ambe"),
                       device="cpu")
    for t in range(vec["frames"].shape[0]):
        state, pcm, res, d = ref.step(codec, torch.as_tensor(vec["frames"][t]), state,
                                      None if rel is None else torch.as_tensor(rel[t]))
        got = np.stack([res[k].numpy() for k in
                        ("c0_errors", "protected_errors", "c4_errors", "total_errors")], -1)
        np.testing.assert_array_equal(got, vec["res"][t], err_msg=f"{name} t={t}")
        np.testing.assert_array_equal(res["flags"].numpy(), vec["flags"][t])
        np.testing.assert_array_equal(d.numpy(), vec["dbits"][t])
        for i in range(pcm.shape[0]):
            assert snr_db(vec["pcm"][t, i], pcm[i].numpy()) >= SNR_MIN_DB, (name, t, i)


def test_runner_is_the_step_in_int16():
    """The runner (the reference as run.py drives it) gives the step's
    int16 PCM and result words, tick after tick from a fresh state."""
    vec = load("e2e_ambe2450_soft")
    seeds = vec["seeds"].astype(np.int64)
    run = runner.Runner("ambe2450", True, True, seeds, "cpu")
    pcm, words = runner.run_sequence(
        run, lambda t: (torch.as_tensor(vec["frames"][t]), torch.as_tensor(vec["rel"][t])), 8)
    state = init_state(len(seeds), seeds, carry_enh=True, device="cpu")
    for t in range(8):
        state, audio, res, _ = ref.step("ambe2450", torch.as_tensor(vec["frames"][t]), state,
                                        torch.as_tensor(vec["rel"][t]))
        assert np.array_equal(pcm[t], float_to_short(audio).numpy())
        assert np.array_equal(words[t], np.stack([res[k].numpy() for k in runner.RESULT_KEYS], -1))


def test_unpack_is_numpy_unpackbits():
    packed = torch.randint(0, 256, (7, 23), dtype=torch.uint8)
    want = np.unpackbits(packed.numpy(), axis=-1)[:, :184]
    assert np.array_equal(runner.unpack(packed, 184).numpy(), want)
