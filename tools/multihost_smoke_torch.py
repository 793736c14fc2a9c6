#!/usr/bin/env python3
"""Multi-process smoke test of the PyTorch port's channel scale-out (port
of tools/multihost_smoke.py).

The decoder has no cross-channel math, so a job of several processes
splits the channels and runs no collective in its hot path
(parallel/sharding.py). This script runs that path for real, as two
processes joined by torch.distributed:

  parent --spawn--> golden child  (one process, the unsharded
                                   run_sequence over all C channels -> npz)
         --spawn--> worker 0 \\    init_process_group("gloo", world_size=2);
         --spawn--> worker 1 /    each takes host_local_slice and
                                  global_channel_mesh(), runs
                                  sharded_sequence over its own channels and
                                  checks them against the golden's slice.

Gloo carries only the barriers and the world size; NCCL is not used (it
refuses two ranks on one GPU). The store is a file in a temporary
directory, so parallel runs never contend for a port.

    python3 tools/multihost_smoke_torch.py [--device cuda|cpu] [--codec C]
        [--channels N] [--frames T] [--timeout S] [--out DIR]

Inputs: by default the golden vector tests/vectors/e2e_<codec>.npz
(ambe2450 unless --codec), its first T = 8 frames with the channels and
seeds tiled 4x (C = 64); with --channels, random frames from
numpy.random.default_rng(0) and per-channel seeds 1..C. Each worker holds
init_state(C / 2, seeds[its slice]) equal to the slice of init_state(C,
seeds) on every leaf (tolerance 0), and its result words and integer
state leaves exactly equal to the golden's slice; its PCM and float state
leaves too on the card. On the CPU, where a matmul rounds by its width,
the int16 PCM is within 1 LSB with fewer than 1e-3 of samples differing
(the rule of tests/test_torch_sharding.py) and each float leaf within
1e-4 of its peak |value|; the CPU workers split their slice over two CPU
shards each, as the JAX job gives each process two devices. On the card
each worker runs on its global_channel_mesh() (both on cuda:0 with one
GPU), its launch counts are asserted, and the script prints each worker's steady ms per frame step while both run, the
aggregate frames/s, and the golden's one-process steady ms per frame step
beside them. --out DIR keeps each worker's outputs (worker<rank>.npz).
Exits 0 and prints MULTIHOST SMOKE OK only when both workers passed; a
child that fails or outlives --timeout fails the run.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NUM_PROCS = 2
TILE_REPS = 4          # the golden vector's channels tiled 4x, as the JAX job
CPU_SHARDS = 2         # CPU shards per worker (the JAX job's devices per process)
TIMING_REPS = 5        # steady runs per process on the card; the fastest is kept
LEAF_TOL = 1e-4        # float state leaves on the CPU: of each leaf's peak


def load_inputs(args):
    """(frames [T, C, rows, cols] int32, seeds [C] uint32), the same in
    every process."""
    from mbe_tpu_torch import pipeline
    if args.channels is None:
        v = np.load(ROOT / "tests" / "vectors" / f"e2e_{args.codec}.npz")
        frames = np.tile(v["frames"][:args.frames], (1, TILE_REPS, 1, 1)).astype(np.int32)
        return frames, np.tile(v["seeds"], TILE_REPS).astype(np.uint32)
    rng = np.random.default_rng(0)
    shape = (args.frames, args.channels, *pipeline.FRAME_SHAPES[args.codec])
    return (rng.integers(0, 2, shape, dtype=np.int8).astype(np.int32),
            np.arange(1, args.channels + 1, dtype=np.uint32))


def setup(args):
    import torch
    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise SystemExit("multihost_smoke_torch: no CUDA device; pass --device cpu")
    return torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")


def to_int16(pcm):
    import torch
    from mbe_tpu_torch.ops.synth import float_to_short
    return float_to_short(torch.from_numpy(pcm)).numpy()


def init(frames, seeds, device, codec):
    from mbe_tpu_torch.models.state import init_state
    return init_state(frames.shape[1], rng_seed=seeds, carry_enh=codec.startswith("ambe"),
                      device=device)


def steady_ms(torch, device, run, frames):
    """The fastest of TIMING_REPS calls of run(), each ended by a
    synchronize, in ms per frame step."""
    best = np.inf
    for _ in range(TIMING_REPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best / frames * 1e3


def run_golden(args):
    """The unsharded compiled step over all C channels in one process:
    PCM, result words and the final state leaves into golden.npz."""
    device = setup(args)
    import torch
    from mbe_tpu_torch import pipeline
    from mbe_tpu_torch.utils import graphs
    frames, seeds = load_inputs(args)
    frames_d = torch.as_tensor(frames, device=device)
    state, pcm, res = pipeline.run_sequence(args.codec, frames_d,
                                            init(frames, seeds, device, args.codec))
    np.savez(Path(args.tmp) / "golden.npz", pcm=pcm.cpu().numpy(),
             **{f"res_{k}": v.cpu().numpy() for k, v in res.items()},
             **{f"leaf_{i}": x.cpu().numpy() for i, x in enumerate(graphs.leaves(state))})
    print(f"golden: {args.codec} C={frames.shape[1]} T={frames.shape[0]} on {device} written",
          flush=True)
    if device.type == "cuda":
        state0 = init(frames, seeds, device, args.codec)
        ms = steady_ms(torch, device,
                       lambda: pipeline.run_sequence(args.codec, frames_d, state0),
                       frames.shape[0])
        print("TIMING " + json.dumps(dict(role="golden", channels=frames.shape[1],
                                          ms_per_step=ms)), flush=True)


def run_worker(args):
    """One process of the two-process job (module docstring)."""
    device = setup(args)
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{Path(args.tmp) / 'store'}",
                            rank=args.rank, world_size=NUM_PROCS,
                            timeout=timedelta(seconds=args.timeout))
    try:
        check_worker(args, device, torch, dist)
    finally:
        dist.destroy_process_group()


def check_worker(args, device, torch, dist):
    from mbe_tpu_torch.ops.cuda import build
    from mbe_tpu_torch.parallel import sharding
    from mbe_tpu_torch.utils import graphs
    assert dist.get_world_size() == NUM_PROCS and dist.get_rank() == args.rank
    frames, seeds = load_inputs(args)
    C, T = frames.shape[1], frames.shape[0]
    n = sharding.host_local_channels(C)
    sl = sharding.host_local_slice(C)
    assert n == C // NUM_PROCS and sl == slice(args.rank * n, (args.rank + 1) * n), (n, sl)
    if device.type == "cuda":
        mesh = sharding.global_channel_mesh()
        device = mesh[0]  # this process's first GPU (cuda:0 for both on one card)
    else:
        mesh = sharding.channel_mesh(["cpu"] * CPU_SHARDS)

    # a process-local start equals the slice of the global one
    local = init(frames[:, sl], seeds[sl], device, args.codec)
    full = graphs.leaves(init(frames, seeds, device, args.codec))
    for i, (a, b) in enumerate(zip(graphs.leaves(local), full)):
        assert torch.equal(a, b[..., sl]), f"init_state leaf {i}: the slice differs"

    build.zero()
    frames_l = torch.as_tensor(frames[:, sl], device=device)
    sequence = sharding.sharded_sequence(args.codec, mesh)
    shards, pcm, res = sequence(frames_l, sharding.shard_state(local, mesh))
    launches = build.counts()
    if device.type == "cuda":
        # per shard a replay per frame and the eager warm-up step before its capture
        steps = len(mesh) * (T + 1)
        want = dict(voiced_sums=steps, soft_decode=0, unvoiced_wola=steps,
                    sources=steps * (3 if args.codec.startswith("ambe") else 2),
                    lane_select=steps * (4 if args.codec.startswith("ambe") else 1))
        assert launches == want, f"kernel launches {launches}, want {want}"

    g = np.load(Path(args.tmp) / "golden.npz")
    leaves = [torch.cat(parts, dim=-1).cpu().numpy()
              for parts in zip(*(graphs.leaves(s) for s in shards))]
    got = pcm.cpu().numpy()
    for k, v in res.items():
        np.testing.assert_array_equal(v.cpu().numpy(), g[f"res_{k}"][:, sl], err_msg=k)
    floats = [("pcm", got, g["pcm"][:, sl])]
    for i, x in enumerate(leaves):
        want = g[f"leaf_{i}"][..., sl]
        if np.issubdtype(x.dtype, np.floating):
            floats.append((f"state leaf {i}", x, want))
        else:
            np.testing.assert_array_equal(x, want, err_msg=f"state leaf {i}")
    for name, x, want in floats:
        if device.type == "cuda":
            np.testing.assert_array_equal(x, want, err_msg=name)
        elif name == "pcm":
            diff = np.abs(to_int16(x).astype(np.int32) - to_int16(want))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, \
                f"int16 PCM: {diff.max()} LSB, {(diff > 0).mean()} of samples differ"
        else:
            np.testing.assert_allclose(x, want, atol=LEAF_TOL * np.abs(want).max(), rtol=0,
                                       err_msg=name)
    if args.out:
        np.savez(Path(args.out) / f"worker{args.rank}.npz", start=sl.start, stop=sl.stop,
                 pcm=got, **{f"res_{k}": v.cpu().numpy() for k, v in res.items()},
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    rule = "exact" if device.type == "cuda" else "within the CPU rule"
    print(f"worker {args.rank}: channels [{sl.start}, {sl.stop}) of {C} on {len(mesh)} "
          f"shard(s) of {mesh[0]}: init_state slice equal; {len(res)} result words and "
          f"{len(leaves) - len(floats) + 1} integer state leaves exact, PCM and "
          f"{len(floats) - 1} float state leaves {rule}, against the golden over {T} "
          f"frames; kernel launches {launches}", flush=True)

    if device.type == "cuda":
        dist.barrier()  # both workers time their steps while the other runs
        ms = steady_ms(torch, device, lambda: sequence(frames_l, shards), T)
        dist.barrier()
        print("TIMING " + json.dumps(dict(role=f"worker {args.rank}", channels=n,
                                          ms_per_step=ms)), flush=True)


def spawn(args, role, tmp, rank=None, log=None):
    cmd = [sys.executable, "-u", __file__, "--role", role, "--tmp", tmp, "--device",
           args.device, "--codec", args.codec, "--frames", str(args.frames),
           "--timeout", str(args.timeout)]
    if args.channels is not None:
        cmd += ["--channels", str(args.channels)]
    if rank is not None:
        cmd += ["--rank", str(rank)]
    if args.out:
        cmd += ["--out", args.out]
    env = dict(os.environ)
    if rank is not None:  # what torchrun sets for one node
        env.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(NUM_PROCS))
    return subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)


def wait_all(procs, timeout):
    """Exit codes of procs; when one fails or the deadline passes, the
    others are killed (their code is then the kill's)."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            break
        time.sleep(0.05)
    return [p.returncode for p in procs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--codec", default="ambe2450",
                    choices=("imbe7200", "imbe7100", "ambe2450", "ambe2400"))
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each child may run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--role", choices=("golden", "worker"), help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.role == "golden":
        return run_golden(args)
    if args.role == "worker":
        return run_worker(args)

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("multihost_smoke_torch: no CUDA device; pass --device cpu", file=sys.stderr)
            return 1
        # built once here, so that no child rebuilds a kernel the other loads
        import mbe_tpu_torch  # noqa: F401  (registers every kernel)
        from mbe_tpu_torch.ops.cuda import build
        for kernel in build.KERNELS:
            kernel.load()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        logs = [open(Path(tmp) / f"{name}.log", "w+") for name in ("golden", "w0", "w1")]
        try:
            codes = wait_all([spawn(args, "golden", tmp, log=logs[0])], args.timeout)
            if codes == [0]:
                codes += wait_all([spawn(args, "worker", tmp, rank=r, log=logs[1 + r])
                                   for r in range(NUM_PROCS)], args.timeout)
            out = []
            for log in logs:
                log.seek(0)
                out.append(log.read())
        finally:
            for log in logs:
                log.close()
    print("".join(out), end="")
    if codes != [0] * (1 + NUM_PROCS):
        print(f"multihost_smoke_torch: child exit codes {codes} (golden, workers)",
              file=sys.stderr)
        return 1
    timing = [json.loads(line[len("TIMING "):]) for text in out for line in text.splitlines()
              if line.startswith("TIMING ")]
    if timing:
        one = timing[0]
        workers = timing[1:]
        agg = sum(w["channels"] / w["ms_per_step"] * 1e3 for w in workers)
        print(f"{len(workers)} processes: ms per frame step "
              f"{[w['ms_per_step'] for w in workers]!r} while both run, aggregate {agg!r} "
              f"frames/s; one process {one['ms_per_step']!r} ms per frame step, "
              f"{one['channels'] / one['ms_per_step'] * 1e3!r} frames/s")
    print(f"MULTIHOST SMOKE OK: {NUM_PROCS} processes on {args.device}, slices == golden "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
