"""The port's channel sharding (mbe_tpu_torch.parallel.sharding, the port
of tests/test_sharding.py) on a mesh of CPU devices: shard states and
frames split on the channel axis (or given per shard, as a list), one
CompiledStep per shard, replayed in rounds, results concatenated (or kept
per shard). The card's two-shard runs (["cuda:0", "cuda:0"], a stream
each) are in tests/test_torch_cuda.py and chip_smoke.py phase 8."""

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


# --- the list form, the options and the rounds ----------------------------------

T_LIST = 6


def _imbe_inputs(vectors, c):
    """e2e_imbe7200_soft's first T_LIST frames, reliabilities and seeds of
    its first c channels."""
    v = vectors("e2e_imbe7200_soft")
    return (torch.from_numpy(v["frames"][:T_LIST, :c].copy()),
            torch.from_numpy(v["rel"][:T_LIST, :c].copy()), v["seeds"][:c])


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


def _close_to_full(got_pcm, got_res, got_state, ref_pcm, ref_res, ref_state):
    """Sharded outputs against one run over all C channels: result words
    and integer state leaves exact; PCM, as int16, within 1 LSB, and float
    state leaves within 1e-3 relative (a CPU matmul rounds by its width,
    and over frames the synthesis carries it on)."""
    for key in ref_res:
        assert torch.equal(got_res[key], ref_res[key].to(torch.int32)), key
    if got_pcm.dtype != torch.int16:
        got_pcm, ref_pcm = synth.float_to_short(got_pcm), synth.float_to_short(ref_pcm)
    assert (got_pcm.int() - ref_pcm.int()).abs().max() <= 1
    for x, y in zip(got_state, graphs.leaves(ref_state)):
        if x.is_floating_point():
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-3, rtol=1e-3)
        else:
            assert torch.equal(x, y)


def _cat_states(shards):
    return [torch.cat(parts, dim=-1) for parts in zip(*(graphs.leaves(s) for s in shards))]


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("k,c", [(1, 10), (2, 13), (3, 10), (4, 13)],
                         ids=["1x10", "2x13", "3x10", "4x13"])
def test_list_form_equals_run_sequence(vectors, k, c, soft, int16):
    """Per-shard frames (and reliabilities) in a list, over two calls (the
    state carried in place): each shard's PCM, result words and state
    equal an unsharded run_sequence of that shard's channels at tolerance
    0, and one run_sequence over all C channels as _close_to_full says;
    the one-tensor form gives the same values, gathered."""
    frames, rel, seeds = _imbe_inputs(vectors, c)
    rel = rel if soft else None
    full = st.init_state(c, rng_seed=seeds, carry_enh=False, device="cpu")
    mesh = sharding.channel_mesh(["cpu"] * k)
    shards = sharding.shard_state(full, mesh)
    tensor_shards = sharding.shard_state(full, mesh)
    alone = sharding.shard_state(full, mesh)
    split = [p.contiguous() for p in torch.tensor_split(frames, k, dim=1)]
    rel_split = [None] * k if rel is None else [
        p.contiguous() for p in torch.tensor_split(rel, k, dim=1)]
    listed = sharding.sharded_sequence("imbe7200", mesh, int16=int16)
    whole = sharding.sharded_sequence("imbe7200", mesh, int16=int16)
    for call in range(2):
        full, ref_pcm, ref_res = pipeline.run_sequence("imbe7200", frames, full, rel, int16=int16)
        shards, pcm, res = listed(split, shards, None if rel is None else rel_split)
        tensor_shards, t_pcm, t_res = whole(frames, tensor_shards, rel)
        assert len(pcm) == len(res) == len(shards) == k
        for i in range(k):
            alone[i], a_pcm, a_res = pipeline.run_sequence("imbe7200", split[i], alone[i],
                                                           rel_split[i], int16=int16)
            assert pcm[i].dtype == (torch.int16 if int16 else torch.float32)
            assert torch.equal(pcm[i], a_pcm), (call, i)
            assert set(res[i]) == set(a_res)
            for key in a_res:
                assert torch.equal(res[i][key], a_res[key]), (call, i, key)
            assert _leaves_equal(shards[i], alone[i]), (call, i)
            assert _leaves_equal(tensor_shards[i], shards[i]), (call, i)
        assert torch.equal(t_pcm, torch.cat(pcm, dim=1))
        for key in t_res:
            assert torch.equal(t_res[key], torch.cat([r[key] for r in res], dim=1)), key
        _close_to_full(t_pcm, t_res, _cat_states(shards), ref_pcm, ref_res, full)


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_sharded_step_int16_and_soft(vectors, soft, int16):
    """sharded_step with reliabilities and int16 output over three CPU
    shards (13 channels, uneven), two frames: PCM, words and state equal
    pipeline.step (step_int16 with int16) of each shard's channels at
    tolerance 0, and of all channels at once as _close_to_full says."""
    c, k = 13, 3
    frames, rel, seeds = _imbe_inputs(vectors, c)
    full = st.init_state(c, rng_seed=seeds, carry_enh=False, device="cpu")
    mesh = sharding.channel_mesh(["cpu"] * k)
    shards = sharding.shard_state(full, mesh)
    parts = sharding.shard_state(full, mesh)
    fn = sharding.sharded_step("imbe7200", mesh, int16=int16)
    one = pipeline.step_int16 if int16 else pipeline.step
    for t in range(2):
        r = rel[t] if soft else None
        full, audio, ref_res, _ = one("imbe7200", frames[t], full, r)
        r_split = [None] * k if r is None else torch.tensor_split(r, k)
        outs = [one("imbe7200", f, p, q)
                for f, p, q in zip(torch.tensor_split(frames[t], k), parts, r_split)]
        parts = [o[0] for o in outs]
        shards, got, res = fn(frames[t], shards, r)
        assert torch.equal(got, torch.cat([o[1] for o in outs])), t
        for key in ref_res:
            assert torch.equal(res[key], torch.cat([o[2][key] for o in outs]).to(torch.int32))
        _close_to_full(got, res, _cat_states(shards), audio, ref_res, full)
    assert all(_leaves_equal(s, p) for s, p in zip(shards, parts))


@pytest.mark.parametrize("form", ["list", "tensor", "step"])
def test_one_round_per_frame(vectors, form):
    """mbe.shard.round is entered once per frame of a call (a
    sharded_step call is one round), whatever the number of shards."""
    from mbe_tpu_torch.utils import profiling
    c, k = 10, 3
    frames, _, seeds = _imbe_inputs(vectors, c)
    mesh = sharding.channel_mesh(["cpu"] * k)
    shards = sharding.shard_state(st.init_state(c, rng_seed=seeds, carry_enh=False,
                                                device="cpu"), mesh)

    def rounds():
        return profiling.snapshot().get("mbe.shard.round", (0, 0))[0]
    before = rounds()
    if form == "step":
        sharding.sharded_step("imbe7200", mesh)(frames[0], shards)
        assert rounds() - before == 1
        return
    fn = sharding.sharded_sequence("imbe7200", mesh)
    arg = ([p.contiguous() for p in torch.tensor_split(frames, k, dim=1)] if form == "list"
           else frames)
    fn(arg, shards)
    assert rounds() - before == T_LIST
    fn(arg, shards)
    assert rounds() - before == 2 * T_LIST


def _bad_call(case, frames, rel, shards, k):
    """The arguments of a list-form call broken as `case` says."""
    split = [p.contiguous() for p in torch.tensor_split(frames, k, dim=1)]
    if case == "short_list":
        return split[:-1], shards, None
    if case == "long_list":
        return split + split[:1], shards, None
    if case == "wide_part":
        return [split[1]] + split[1:], shards, None        # 4 channels where shard 0 has 5
    if case == "time":
        return [split[0][:2]] + split[1:], shards, None
    if case == "other_device":
        return [split[0].to("meta")] + split[1:], shards, None
    if case == "mixed":
        return split, shards, rel
    if case == "rel_width":
        return split, shards, [p[:, :1].contiguous() for p in torch.tensor_split(rel, k, dim=1)]
    if case == "states":
        return split, shards[:1], None
    raise ValueError(case)


@pytest.mark.parametrize("case", ["short_list", "long_list", "wide_part", "time",
                                  "other_device", "mixed", "rel_width", "states"])
def test_list_form_rejects_what_does_not_fit(vectors, case):
    """A list of another length than the mesh, a part of another width or
    length, a part off its shard's device, reliabilities in the other form
    or of another width, or too few shard states: ValueError, before any
    shard runs (the states are left as they were)."""
    c, k = 9, 2
    frames, rel, seeds = _imbe_inputs(vectors, c)
    mesh = sharding.channel_mesh(["cpu"] * k)
    shards = sharding.shard_state(st.init_state(c, rng_seed=seeds, carry_enh=False,
                                                device="cpu"), mesh)
    kept = [[x.clone() for x in graphs.leaves(s)] for s in shards]
    with pytest.raises(ValueError):
        sharding.sharded_sequence("imbe7200", mesh)(*_bad_call(case, frames, rel, shards, k))
    for s, want in zip(shards, kept):
        assert all(torch.equal(x, y) for x, y in zip(graphs.leaves(s), want))


def test_devices_are_named_or_refused(monkeypatch):
    """A mesh or a graph on "cuda" without an index, or a shard state off
    its mesh device, raises instead of running on the current device."""
    state = st.init_state(4, rng_seed=np.arange(1, 5, dtype=np.uint32), carry_enh=False,
                          device="cpu")
    mesh = sharding.channel_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="mesh device is meta"):
        sharding.sharded_step("imbe7200", mesh)(torch.zeros((4, 8, 23), dtype=torch.int32),
                                                sharding.shard_state(state, ["cpu", "cpu"]))
    with pytest.raises(ValueError, match="index"):
        graphs.Captured(lambda: None, "cuda", warmup=lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no index"):
        sharding.channel_mesh(["cuda", "cuda"])


def test_capture_stays_on_its_device(monkeypatch):
    """Captured warms up and captures on one side stream made on its own
    device, under that device's guard: torch.cuda.graph's default capture
    stream is made once, on the device current at the first capture in the
    process, and would move a capture for cuda:1 onto cuda:0. Recorded on
    stand-ins for the CUDA calls (the capture itself needs a card)."""
    import contextlib
    current, seen = ["cuda:0"], []

    class Stream:
        def __init__(self):
            self.device = current[0]

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def device(d):
        before, current[0] = current[0], str(torch.device(d))
        yield
        current[0] = before

    @contextlib.contextmanager
    def on_stream(stream):
        seen.append(("stream", stream.device, current[0]))
        yield

    @contextlib.contextmanager
    def graph(g, stream=None):
        seen.append(("capture", None if stream is None else stream.device, current[0]))
        yield

    for name, fake in (("device", device), ("Stream", Stream), ("stream", on_stream),
                       ("graph", graph), ("current_stream", lambda d=None: Stream()),
                       ("CUDAGraph", lambda: object())):
        monkeypatch.setattr(torch.cuda, name, fake)
    for d in ("cuda:1", "cuda:3"):
        seen.clear()
        graphs.Captured(lambda: "out", d, warmup=lambda: None)
        assert seen == [("stream", d, d), ("capture", d, d)], seen
    assert current == ["cuda:0"]
