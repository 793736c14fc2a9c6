"""The port's multi-process scale-out (the port of tests/test_multihost.py,
here on every run): tools/multihost_smoke_torch.py's real two-process
torch.distributed ("gloo") job on the CPU, its workers' outputs held
against the committed golden vector and against the port's
single-process run; and the rules of parallel/sharding.py's
global_channel_mesh and host_local_slice, with torch.distributed and the
CUDA device count stood in. The same job on cuda:0 is in
tests/test_torch_cuda.py and chip_smoke.py phase 9."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import snr_db
from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import synth
from mbe_tpu_torch.parallel import sharding
from mbe_tpu_torch.utils import graphs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "multihost_smoke_torch.py"
RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")


def test_two_process_job_matches_golden_and_one_process(vectors, tmp_path):
    """e2e_ambe2450's first 8 frames, channels and seeds tiled 4x (C = 64),
    over two gloo processes of two CPU shards each. Each worker's slice,
    reassembled: against the golden vector, result words and flags exact
    and >= 60 dB per frame and lane; against the port's one-process
    run_sequence, result words and integer state leaves exact, the int16
    PCM within 1 LSB with fewer than 1e-3 of samples differing (the rule
    of tests/test_torch_sharding.py; a CPU matmul rounds by its width) and
    each float leaf within 1e-4 of its peak |value|."""
    proc = subprocess.run([sys.executable, str(TOOL), "--device", "cpu", "--timeout", "50",
                           "--out", str(tmp_path)], capture_output=True, text=True,
                          timeout=55)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST SMOKE OK" in proc.stdout
    for rank in (0, 1):
        assert f"worker {rank}: channels [{32 * rank}, {32 * rank + 32}) of 64" in proc.stdout

    parts = [dict(np.load(tmp_path / f"worker{r}.npz")) for r in (0, 1)]
    assert [(int(p["start"]), int(p["stop"])) for p in parts] == [(0, 32), (32, 64)]
    pcm = np.concatenate([p["pcm"] for p in parts], axis=1)
    res = {k[len("res_"):]: np.concatenate([p[k] for p in parts], axis=1)
           for k in parts[0] if k.startswith("res_")}
    leaves = [np.concatenate([p[f"leaf_{i}"] for p in parts], axis=-1)
              for i in range(sum(k.startswith("leaf_") for k in parts[0]))]

    v = vectors("e2e_ambe2450")
    T, c16 = 8, v["frames"].shape[1]
    tile = np.arange(4 * c16) % c16
    got = np.stack([res[k] for k in RES_KEYS], axis=-1)
    np.testing.assert_array_equal(got, v["res"][:T][:, tile])
    np.testing.assert_array_equal(res["flags"], v["flags"][:T][:, tile])
    worst = min(snr_db(v["pcm"][t, tile[i]], pcm[t, i]) for t in range(T) for i in range(64))
    assert worst >= 60.0, worst

    frames = torch.from_numpy(np.tile(v["frames"][:T], (1, 4, 1, 1)).astype(np.int32))
    seeds = np.tile(v["seeds"], 4).astype(np.uint32)
    ref_state, ref_pcm, ref_res = pipeline.run_sequence(
        "ambe2450", frames, st.init_state(64, rng_seed=seeds, device="cpu"))
    assert set(res) == set(ref_res)
    for k in ref_res:
        np.testing.assert_array_equal(res[k], ref_res[k].numpy(), err_msg=k)
    diff = np.abs(synth.float_to_short(torch.from_numpy(pcm)).int().numpy()
                  - synth.float_to_short(ref_pcm).int().numpy())
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    ref_leaves = graphs.leaves(ref_state)
    assert len(leaves) == len(ref_leaves)
    for i, (a, b) in enumerate(zip(leaves, ref_leaves)):
        if b.is_floating_point():
            np.testing.assert_allclose(a, b.numpy(), atol=1e-4 * b.abs().max().item(), rtol=0,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=str(i))


def _dist(monkeypatch, rank, world):
    """torch.distributed stood in for process `rank` of a job of `world`."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)


def _gpus(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("gpus,local", [(8, 8), (8, 4), (8, 3), (4, 1), (2, 2)],
                         ids=["8gpu-8proc", "8gpu-4proc", "8gpu-3proc", "4gpu-1proc",
                              "2gpu-2proc"])
@pytest.mark.parametrize("torchrun_env", [True, False], ids=["local-env", "dist-rank"])
def test_global_channel_mesh_disjoint_when_processes_fit(monkeypatch, gpus, local,
                                                         torchrun_env):
    """L <= n: process r of L gets {i : i % L == r}; the node's processes
    hold every GPU once. Local rank and size come from LOCAL_RANK and
    LOCAL_WORLD_SIZE (torchrun), else from the distributed rank and size."""
    _gpus(monkeypatch, gpus)
    seen = []
    for r in range(local):
        if torchrun_env:
            # a second node's process: global rank and size differ from the local ones
            _dist(monkeypatch, local + r, 2 * local)
            monkeypatch.setenv("LOCAL_RANK", str(r))
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
        else:
            _dist(monkeypatch, r, local)
            monkeypatch.delenv("LOCAL_RANK", raising=False)
            monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        mesh = sharding.global_channel_mesh()
        assert mesh == [torch.device("cuda", i) for i in range(r, gpus, local)]
        seen += mesh
    assert sorted(d.index for d in seen) == list(range(gpus))


@pytest.mark.parametrize("gpus,local", [(1, 2), (1, 4), (2, 3), (3, 8)])
def test_global_channel_mesh_shared_when_processes_exceed_gpus(monkeypatch, gpus, local):
    """L > n: process r gets [cuda:(r % n)] alone, so processes share a
    card round-robin."""
    _gpus(monkeypatch, gpus)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    for r in range(local):
        _dist(monkeypatch, r, local)
        monkeypatch.setenv("LOCAL_RANK", str(r))
        assert sharding.global_channel_mesh() == [torch.device("cuda", r % gpus)]


def test_global_channel_mesh_unchanged_without_distributed(monkeypatch):
    """Not initialized: every CUDA device, whatever LOCAL_* say; without a
    GPU it raises, as channel_mesh does."""
    _gpus(monkeypatch, 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    assert sharding.global_channel_mesh() == [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.global_channel_mesh()


@pytest.mark.parametrize("total,world,inexact", [(64, 2, 3), (32768, 2, 3), (1026, 3, 4),
                                                 (7, 1, 2), (96, 8, 9)])
def test_host_local_slice_partitions_channels(monkeypatch, total, world, inexact):
    """Process p of P owns [p C / P, (p + 1) C / P): over all ranks the
    slices cover [0, C) once, in rank order, each host_local_channels
    long; an inexact split raises."""
    covered = []
    for p in range(world):
        _dist(monkeypatch, p, world)
        sl = sharding.host_local_slice(total)
        assert sl.stop - sl.start == sharding.host_local_channels(total) == total // world
        covered += range(total)[sl]
    assert covered == list(range(total))
    _dist(monkeypatch, 0, inexact)
    with pytest.raises(ValueError, match="processes"):
        sharding.host_local_slice(total)


def test_host_local_slice_single_process():
    assert sharding.host_local_slice(1000) == slice(0, 1000)


@pytest.mark.parametrize("carry_enh", [True, False])
@pytest.mark.parametrize("seeded", [True, False])
def test_init_state_slice_equals_local_start(carry_enh, seeded):
    """init_state(C / P, seeds[slice]) equals the slice of init_state(C,
    seeds) on every leaf, tolerance 0: what makes a process-local start
    valid (seed 0 included, which maps to 0x6D25357B)."""
    C, P = 96, 3
    seeds = None
    if seeded:
        seeds = (np.arange(C, dtype=np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    full = graphs.leaves(st.init_state(C, rng_seed=seeds, carry_enh=carry_enh, device="cpu"))
    for p in range(P):
        sl = slice(p * C // P, (p + 1) * C // P)
        local = st.init_state(C // P, rng_seed=None if seeds is None else seeds[sl],
                              carry_enh=carry_enh, device="cpu")
        leaves = graphs.leaves(local)
        assert len(leaves) == len(full)
        for i, (a, b) in enumerate(zip(leaves, full)):
            assert torch.equal(a, b[..., sl]), i
