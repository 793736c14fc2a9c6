"""The harness's check fails a broken program: each fault that a cell can
have, planted in the program's step underneath a whole run (on the CPU, at
a small size, the look for a CUDA device skipped), turns `correct` false;
the unbroken program passes."""

import json

import pytest
import torch

from portbench import run as harness

SMALL = dict(channels=48, check_channels=48, pool_ticks=4, warmup_ticks=2, warmup_chunks=1,
             trace_start=1, trace_steps=2)


def broken(step, fault):
    """pipeline.step with `fault` planted where the step produces its
    outputs."""
    def faulty(codec, frame, state, soft_rel=None, *a, **k):
        new_state, audio, res, d = step(codec, frame, state, soft_rel, *a, **k)
        if fault == "state_unchanged":
            return state, audio, res, d
        if fault == "half_batch":
            # the upper half of the channels left out: silent, not decoded
            c = audio.shape[0]
            keep = torch.arange(c) < c // 2
            from mbe_tpu_torch.models.state import map_state
            new_state = map_state(
                lambda n, o: torch.where(keep.reshape((1,) * (n.ndim - 1) + (-1,)), n, o),
                new_state, state)
            audio = torch.where(keep[:, None], audio, 0.0)
            res = {kk: torch.where(keep, v, 0) for kk, v in res.items()}
            return new_state, audio, res, d
        if fault == "word_altered":
            res = dict(res, total_errors=res["total_errors"] + 1)
            return new_state, audio, res, d
        if fault == "pcm_altered":
            return new_state, audio + 2000.0 / 7.0, res, d
        raise ValueError(fault)
    return faulty


def run_cell(workload, capsys, seed=2 ** 31 + 77):
    from mbe_tpu_torch import pipeline
    pipeline.clear_compiled()
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.3",
                       "--trace", "0"], device="cpu", overrides=SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "ambe2450-soft.batch"])
def test_sound_program_is_correct(workload, capsys):
    result = run_cell(workload, capsys)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "word_altered",
                                   "pcm_altered"])
@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "ambe2450-soft.batch",
                                      "imbe7200-hard.batch"])
def test_fault_is_not_correct(workload, fault, capsys, monkeypatch):
    from mbe_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "step", broken(pipeline.step, fault))
    result = run_cell(workload, capsys)
    assert result["correct"] is False, (fault, result["checks"])
