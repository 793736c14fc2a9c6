"""The port's compiled step (mbe_tpu_torch.pipeline.CompiledStep, the
counterpart of jax.jit with the state donated) and run_sequence on it, on
the CPU, where the same body runs eagerly on the same static buffers that
the card's CUDA graph captures.

CompiledStep and run_sequence equal a Python loop over pipeline.step at
tolerance 0 (integers, PCM, parameter bits, every state leaf) on the e2e
goldens of the four codecs, hard and soft, and meet the goldens' own bar;
the static state is updated in place and a returned sequence state
aliases nothing; after one warm-up step no step builds a tensor from host
data (which on the card would be a blocking upload, and inside a capture
an error). The card's graph replay is held in tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

from conftest import snr_db
from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.utils import graphs

torch.set_num_threads(1)

RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")
CASES = [(codec, soft) for codec in pipeline.CODECS for soft in (False, True)]
IDS = [f"{codec}-{'soft' if soft else 'hard'}" for codec, soft in CASES]


def _golden(vectors, codec, soft):
    vec = vectors(f"e2e_{codec}_soft" if soft else f"e2e_{codec}")
    frames = torch.from_numpy(vec["frames"])
    rel = torch.from_numpy(vec["rel"]) if soft else None
    return vec, frames, rel


def _init(vec, codec):
    return st.init_state(vec["frames"].shape[1], rng_seed=vec["seeds"],
                         carry_enh=codec.startswith("ambe"), device="cpu")


def _same_state(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("codec,soft", CASES, ids=IDS)
def test_compiled_step_and_run_sequence_equal_eager(vectors, codec, soft):
    """Eager loop vs CompiledStep vs run_sequence over one e2e golden:
    tolerance 0 everywhere; the eager loop meets the golden's bar
    (integers exact, >= 60 dB per frame and lane)."""
    vec, frames, rel = _golden(vectors, codec, soft)
    T = frames.shape[0]
    state = _init(vec, codec)
    eager = []
    for t in range(T):
        state, audio, res, d = pipeline.step(codec, frames[t], state,
                                             None if rel is None else rel[t])
        eager.append((audio, res, d, state))
        np.testing.assert_array_equal(d.numpy(), vec["dbits"][t])
        np.testing.assert_array_equal(np.stack([res[k].numpy() for k in RES_KEYS], 1),
                                      vec["res"][t])
        np.testing.assert_array_equal(res["flags"].numpy(), vec["flags"][t])
        for i in range(frames.shape[1]):
            assert snr_db(vec["pcm"][t, i], audio[i].numpy()) >= 60.0, (t, i)

    compiled = pipeline.CompiledStep(codec, _init(vec, codec), soft=soft)
    # int8 frames: copy_ converts into the int32 static input
    for t in range(T):
        out_state, audio, res = compiled(frames[t].to(torch.int8),
                                         None if rel is None else rel[t])
        e_audio, e_res, e_d, e_state = eager[t]
        assert out_state is compiled.state
        assert torch.equal(audio, e_audio) and torch.equal(compiled.dbits, e_d)
        assert all(torch.equal(res[k], e_res[k]) for k in e_res) and set(res) == set(e_res)
        assert _same_state(out_state, e_state), t

    init = _init(vec, codec)
    seq_state, pcm, results = pipeline.run_sequence(codec, frames, init, rel)
    assert torch.equal(pcm, torch.stack([e[0] for e in eager]))
    for k in eager[0][1]:
        assert torch.equal(results[k], torch.stack([e[1][k] for e in eager])), k
    assert _same_state(seq_state, eager[-1][3])
    assert _same_state(init, _init(vec, codec)), "run_sequence changed the caller's state"


def test_donation_and_unaliased_sequence_state(vectors):
    """CompiledStep updates the state it was given in place (the same
    tensors, new values); run_sequence returns a state that shares no
    storage with the compiled step's and that a later call leaves as it
    was; int16 output is float_to_short's."""
    vec, frames, _ = _golden(vectors, "imbe7200", False)
    state = _init(vec, "imbe7200")
    ptrs = [x.data_ptr() for x in graphs.leaves(state)]
    before = [x.clone() for x in graphs.leaves(state)]
    compiled = pipeline.CompiledStep("imbe7200", state)
    out, audio, _ = compiled(frames[0])
    assert out is state and [x.data_ptr() for x in graphs.leaves(state)] == ptrs
    assert not all(torch.equal(a, b) for a, b in zip(before, graphs.leaves(state)))
    _, ref, _, _ = pipeline.step("imbe7200", frames[0], _init(vec, "imbe7200"))
    assert torch.equal(audio, ref)
    with pytest.raises(ValueError, match="soft"):
        compiled(frames[1], frames[1])
    with pytest.raises(ValueError, match="frame"):
        compiled(frames[1][:3])

    first, pcm, _ = pipeline.run_sequence("imbe7200", frames[:3], _init(vec, "imbe7200"))
    kept = [x.clone() for x in graphs.leaves(first)]
    cached = pipeline.compiled_step("imbe7200", first)
    static = {x.untyped_storage().data_ptr() for x in graphs.leaves(cached.state)}
    assert not static & {x.untyped_storage().data_ptr() for x in graphs.leaves(first)}
    _, pcm16, _ = pipeline.run_sequence("imbe7200", frames[3:6], first, int16=True)
    assert all(torch.equal(a, b) for a, b in zip(kept, graphs.leaves(first)))
    _, pcm_f, _ = pipeline.run_sequence("imbe7200", frames[3:6], first)
    assert pcm16.dtype == torch.int16
    assert torch.equal(pcm16, pipeline.synth_ops.float_to_short(pcm_f))


def test_copy_into_clones_passed_through_leaves():
    """A new leaf that is an old one (a body that swaps two leaves) is read
    before any copy writes it."""
    a, b = torch.zeros(3), torch.ones(3)
    graphs.copy_into([a, b], [b + 1, a])      # new a = old b + 1, new b = old a
    assert a.tolist() == [2.0] * 3 and b.tolist() == [0.0] * 3
    with pytest.raises(ValueError, match="int32"):
        graphs.copy_into([a], [torch.zeros(3, dtype=torch.int32)])


class _HostDataGuard:
    """Raises on any tensor built from host data (numpy, list, range,
    number) and on any index given as a list, array or range: on the card
    each is a blocking upload, and inside a CUDA graph capture an error."""

    FACTORIES = ("as_tensor", "tensor", "from_numpy", "asarray")

    def __init__(self, monkeypatch):
        for name in self.FACTORIES:
            monkeypatch.setattr(torch, name, self._factory(name, getattr(torch, name)))
        for name in ("__getitem__", "__setitem__"):
            monkeypatch.setattr(torch.Tensor, name,
                                self._indexer(name, getattr(torch.Tensor, name)))
        new_tensor = torch.Tensor.new_tensor
        monkeypatch.setattr(torch.Tensor, "new_tensor", self._factory("new_tensor", new_tensor,
                                                                      offset=1))

    @staticmethod
    def _factory(name, fn, offset=0):
        def guarded(*args, **kwargs):
            data = args[offset] if len(args) > offset else kwargs.get("data")
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name} of host data {type(data).__name__}")
            return fn(*args, **kwargs)
        return guarded

    @staticmethod
    def _indexer(name, fn):
        def guarded(self, index, *rest):
            parts = index if isinstance(index, tuple) else (index,)
            if any(isinstance(p, (list, range, np.ndarray)) for p in parts):
                raise AssertionError(f"Tensor.{name} with a host index {type(index).__name__}")
            return fn(self, index, *rest)
        return guarded


@pytest.mark.parametrize("codec,soft", CASES, ids=IDS)
def test_step_builds_no_tensor_from_host_data(vectors, monkeypatch, codec, soft):
    """After one warm-up step per (codec, soft), which fills the per-device
    constant caches, a further pipeline.step (and its int16 variant) makes
    no tensor from host data."""
    vec, frames, rel = _golden(vectors, codec, soft)
    state = _init(vec, codec)
    r0, r1 = (None, None) if rel is None else (rel[0], rel[1])
    state, *_ = pipeline.step(codec, frames[0], state, r0)
    _HostDataGuard(monkeypatch)
    with pytest.raises(AssertionError, match="host data"):
        torch.as_tensor(np.zeros(3))           # the guard is on
    state, audio, res, _ = pipeline.step_int16(codec, frames[1], state, r1)
    assert audio.dtype == torch.int16 and (res["status"] == 0).all()
