"""The port's channel sharding (mbe_tpu_torch.parallel.sharding, the port
of tests/test_sharding.py) on a mesh of CPU devices: shard states and
frames split on the channel axis, one CompiledStep per shard, results
concatenated. The card's two-shard run (["cuda:0", "cuda:0"], a stream
each) is in tests/test_torch_cuda.py and chip_smoke.py phase 8."""

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
from mbe_tpu_torch.parallel import sharding
from mbe_tpu_torch.utils import graphs

torch.set_num_threads(1)


def _frame_and_seeds(c, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (c, 4, 24)).astype(np.int32),
            np.arange(1, c + 1).astype(np.uint32))


@pytest.mark.parametrize("k,c", [(1, 8), (2, 8), (3, 10)], ids=["1x8", "2x8", "3x10"])
def test_sharded_step_equals_unsharded(k, c):
    """["cpu"] * k shards (3 x 10: uneven) over two calls, the second
    passing the returned (donated) shard states back: tolerance 0 against
    unsharded steps of each shard's channels, and against one step of all
    C channels integers exact and PCM within 1e-3 (a CPU matmul rounds by
    its width, at the 1e-5 level here)."""
    frame, seeds = _frame_and_seeds(c)
    frames = torch.from_numpy(np.stack([frame, frame[::-1].copy()]))
    mesh = sharding.channel_mesh(["cpu"] * k)
    full = st.init_state(c, rng_seed=seeds, device="cpu")
    parts = sharding.shard_state(full, mesh)
    shards = sharding.shard_state(full, mesh)
    fn = sharding.sharded_step("ambe2450", mesh)
    for t in range(2):
        full, audio, res, _ = pipeline.step("ambe2450", frames[t], full)
        split = torch.tensor_split(frames[t], k)
        outs = [pipeline.step("ambe2450", f, p) for f, p in zip(split, parts)]
        parts = [o[0] for o in outs]
        shards, got, got_res = fn(frames[t], shards)
        assert torch.equal(got, torch.cat([o[1] for o in outs]))
        np.testing.assert_allclose(got.numpy(), audio.numpy(), atol=1e-3, rtol=1e-5)
        for key in res:
            assert torch.equal(got_res[key], torch.cat([o[2][key] for o in outs])), key
            assert torch.equal(got_res[key], res[key]), key
    for shard, part in zip(shards, parts):
        assert all(torch.equal(x, y) for x, y in zip(graphs.leaves(shard), graphs.leaves(part)))


def test_sharded_step_matches_jax():
    """The port's sharded step against mbe_tpu.pipeline.step on the same
    seeded frame: integer results and state exact. The PCM of two packages
    differs by their float order: within 1e-3 of its peak (the 1e-3 rule of
    tests/test_sharding.py, which compares two runs of one package, is
    held between sharded and unsharded runs above) and >= 60 dB per lane,
    the port's bar against the reference."""
    c = 16
    frame, seeds = _frame_and_seeds(c)
    ref_state, ref_audio, ref_res, _ = jax.jit(
        lambda f, s: jpipeline.step("ambe2450", f, s))(frame, jst.init_state(c, rng_seed=seeds))
    mesh = sharding.channel_mesh(["cpu", "cpu"])
    shards = sharding.shard_state(st.init_state(c, rng_seed=seeds, device="cpu"), mesh)
    shards, audio, res = sharding.sharded_step("ambe2450", mesh, donate=False)(
        torch.from_numpy(frame), shards)
    ref_audio = np.asarray(ref_audio)
    np.testing.assert_allclose(audio.numpy(), ref_audio, atol=1e-3 * np.abs(ref_audio).max(),
                               rtol=0)
    for i in range(c):
        assert snr_db(ref_audio[i], audio[i].numpy()) >= 60.0, i
    for k in ("c0_errors", "protected_errors", "total_errors", "flags"):
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(ref_res[k]), err_msg=k)
    for k in ("L", "Vl", "repeatCount"):
        got = torch.cat([getattr(s.cur, k) for s in shards], dim=-1).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(ref_state.cur, k)), err_msg=k)
    got_ml = torch.cat([s.cur.Ml for s in shards], dim=-1).numpy()
    np.testing.assert_allclose(got_ml, np.asarray(ref_state.cur.Ml), atol=1e-3, rtol=1e-4)


def test_sharded_golden_sequence_matches_unsharded(vectors):
    """e2e_ambe2450 with its channels (and seeds) tiled x4, sharded over
    four CPU devices by sharded_sequence against the unsharded
    run_sequence: int16 PCM within 1 LSB with fewer than 1e-3 of samples
    differing (the rule of tests/test_sharding.py), integer results and
    state exact."""
    v = vectors("e2e_ambe2450")
    frames = torch.from_numpy(np.tile(v["frames"], (1, 4, 1, 1)))
    seeds = np.tile(v["seeds"], 4)
    c = frames.shape[1]
    ref_state, ref_pcm, ref_res = pipeline.run_sequence(
        "ambe2450", frames, st.init_state(c, rng_seed=seeds, device="cpu"))
    mesh = sharding.channel_mesh(["cpu"] * 4)
    shards = sharding.shard_state(st.init_state(c, rng_seed=seeds, device="cpu"), mesh)
    shards, pcm, res = sharding.sharded_sequence("ambe2450", mesh)(frames, shards)
    diff = (synth.float_to_short(ref_pcm).int() - synth.float_to_short(pcm).int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
    for k in ref_res:
        assert torch.equal(res[k], ref_res[k]), k
    for k in ("L", "Vl"):
        got = torch.cat([getattr(s.cur, k) for s in shards], dim=-1)
        assert torch.equal(got, getattr(ref_state.cur, k)), k


def test_shard_state_keeps_the_trailing_channel_axis():
    """state_spec is the trailing axis; shard_state splits every leaf on it
    into contiguous copies that share no memory with the state, and
    donate=False leaves the passed shards intact."""
    state = st.init_state(7, rng_seed=np.arange(1, 8, dtype=np.uint32), device="cpu")
    mesh = sharding.channel_mesh(["cpu", "cpu"])
    shards = sharding.shard_state(state, mesh)
    for leaf, a, b in zip(graphs.leaves(state), graphs.leaves(shards[0]),
                          graphs.leaves(shards[1])):
        assert sharding.state_spec(leaf) == leaf.ndim - 1
        assert a.shape[:-1] == leaf.shape[:-1] and (a.shape[-1], b.shape[-1]) == (4, 3)
        assert a.is_contiguous() and b.is_contiguous()
        assert a.untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()
        assert torch.equal(torch.cat([a, b], dim=-1), leaf)
    kept = [x.clone() for x in graphs.leaves(shards[0])]
    out, _, _ = sharding.sharded_step("imbe7100", mesh, donate=False)(
        torch.zeros((7, 7, 24), dtype=torch.int32), shards)
    assert all(torch.equal(x, y) for x, y in zip(kept, graphs.leaves(shards[0])))
    assert out[0] is not shards[0]


def test_channel_mesh_and_host_local_channels(monkeypatch):
    """The default mesh is every CUDA device and raises without one;
    host_local_channels divides by the torch.distributed world size (1 in
    one process) and raises on an inexact split."""
    assert sharding.host_local_channels(1024) == 1024
    assert sharding.channel_mesh(["cpu"]) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.channel_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.global_channel_mesh()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    assert sharding.host_local_channels(1026) == 342
    with pytest.raises(ValueError, match="3 processes"):
        sharding.host_local_channels(1024)
