"""The sharded entry: `parallel.sharding.sharded_sequence` over the run's
devices, each shard's frames and outputs on its own device.

The mesh is the run's devices in their order; the pool's frames and the
channel state are split by channel over it as `torch.tensor_split` cuts
them, and each shard's part is copied to its own device (a site's frames
arrive for the card that decodes them). Each call decodes the whole pool
(pool_ticks frames) for every channel in one `sharded_sequence` call over
the per-shard list, int16 PCM out, the state carried from call to call.
Each shard's PCM is consumed on its own device by a reduction into that
shard's accumulator (a stand-in for a GPU consumer such as speech
recognition), and the checked sample's channels that lie in the shard are
kept there; nothing is read back inside the window but the accumulators
at its end. frames_per_s counts every channel-frame of every call over
the window's wall seconds.
"""

import time

import numpy as np
import torch

from portbench.reference.runner import RESULT_KEYS


def setup(run, pool):
    """Split the pool and the state over the mesh, build the sequence and
    run the warm-up calls (the first captures each shard's CUDA graph)."""
    from mbe_tpu_torch import init_state
    from mbe_tpu_torch.parallel import sharding

    run.mesh = sharding.channel_mesh(run.devices)
    k = len(run.mesh)
    # the whole pool stays on the first device for the reference's inputs
    run.frames = pool.bits
    run.rel = pool.rel if run.soft else None
    if not run.soft:
        del pool.rel
    run.ref_inputs = lambda: (run.frames, run.rel)
    run.hold(run.frames, run.rel)

    def parts(x):
        if x is None:
            return None
        return [torch.empty(p.shape, dtype=p.dtype, device=d).copy_(p)
                for p, d in zip(torch.tensor_split(x, k, dim=1), run.mesh)]
    run.frame_parts, run.rel_parts = parts(run.frames), parts(run.rel)
    run.hold(*run.frame_parts, *(run.rel_parts or []))

    state = init_state(run.channels, run.pool_seeds, carry_enh=bool(run.config["carry_enh"]),
                       device=run.device)
    run.states = sharding.shard_state(state, run.mesh)
    del state
    run.sequence = sharding.sharded_sequence(run.codec, run.mesh, int16=True)

    # each shard's channels of the sample, as indices into the shard
    bounds = np.cumsum([0] + [p.shape[1] for p in run.frame_parts])
    run.sample_parts = [torch.as_tensor(run.sample[(run.sample >= lo) & (run.sample < hi)] - lo,
                                        device=d)
                        for lo, hi, d in zip(bounds[:-1], bounds[1:], run.mesh)]
    run.accs = [torch.zeros((), dtype=torch.int64, device=d) for d in run.mesh]
    run.hold(*run.sample_parts, *run.accs)
    run.kept = [[] for _ in run.mesh]    # per shard, per call: (pcm, words) of its sample
    run.ticks = 0
    run.steps_per_call = run.frames.shape[0]
    for _ in range(int(run.traffic["warmup_chunks"])):
        chunk(run)


def chunk(run):
    """One sharded_sequence call over the pool, then each shard's
    consumer on its own device."""
    with run.span("run_sequence"):
        run.states, pcm, res = run.sequence(run.frame_parts, run.states, run.rel_parts)
    with run.span("consume"):
        for i, (p, r) in enumerate(zip(pcm, res)):
            run.took(p, *r.values())
            run.accs[i] += p.sum(dtype=torch.int64)
            index = run.sample_parts[i]
            kept = (p.index_select(1, index),
                    torch.stack([r[k].index_select(1, index) for k in RESULT_KEYS], -1))
            run.kept[i].append(kept)
            # the sample's record is the harness's, not the program's memory
            run.hold(*kept)
    run.ticks += pcm[0].shape[0]


def window(run):
    calls = 0
    t0 = time.perf_counter()
    while True:
        run.traced_step(calls)
        chunk(run)
        calls += 1
        if time.perf_counter() - t0 >= run.args.seconds:
            break
    with run.span("readback"):
        run.checksum = sum(int(a.item()) for a in run.accs)
    wall = time.perf_counter() - t0
    return {"frames_per_s": calls * run.frames.shape[0] * run.channels / wall,
            "attempted": calls * run.frames.shape[0] * run.channels}


def finish(run):
    """Free the shards' states and graphs. Returns the sample's outputs
    (pcm [T, S, 160], words [T, S, 5], channels in run.sample's order: the
    shards' in mesh order) and the ticks run."""
    del run.states, run.sequence
    pcm = np.concatenate([torch.cat([p for p, _ in kept]).cpu().numpy() for kept in run.kept],
                         axis=1)
    words = np.concatenate([torch.cat([w for _, w in kept]).cpu().numpy() for kept in run.kept],
                           axis=1)
    run.kept = []
    return pcm, words, run.ticks
