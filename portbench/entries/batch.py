"""The batch entry: `pipeline.run_sequence` over chunks of the pool.

Each call decodes the whole pool (pool_ticks frames, 1 s of audio per
channel at 50) for every channel, frames (and reliabilities) already on
the device, the state carried from call to call. The PCM is consumed on
the device by a reduction into an accumulator (a stand-in for a GPU
consumer such as speech recognition); nothing is read back inside the
window but the accumulator at its end. frames_per_s counts every
channel-frame of every call over the window's wall seconds.
"""

import time

import torch

from portbench.reference.runner import RESULT_KEYS


def setup(run, pool):
    """Build the state, run the warm-up chunks (the first captures the
    step's CUDA graph)."""
    from mbe_tpu_torch import init_state

    run.frames = pool.bits
    run.rel = pool.rel if run.soft else None
    if not run.soft:
        del pool.rel
    run.ref_inputs = lambda: (run.frames, run.rel)
    run.state = init_state(run.channels, run.pool_seeds, carry_enh=bool(run.config["carry_enh"]),
                           device=run.device)
    run.sample_dev = torch.as_tensor(run.sample, device=run.device)
    run.acc = torch.zeros((), dtype=torch.int64, device=run.device)
    run.hold(run.frames, run.rel, run.acc)
    run.ticks = 0
    run.steps_per_call = run.frames.shape[0]
    for _ in range(int(run.traffic["warmup_chunks"])):
        chunk(run)


def chunk(run):
    """One run_sequence call over the pool, then the consumer."""
    from mbe_tpu_torch import pipeline

    with run.span("run_sequence"):
        run.state, pcm, res = pipeline.run_sequence(run.codec, run.frames, run.state, run.rel,
                                                    int16=True)
    with run.span("consume"):
        run.took(pcm, *res.values())
        run.acc += pcm.sum(dtype=torch.int64)
        kept = (pcm.index_select(1, run.sample_dev),
                torch.stack([res[k].index_select(1, run.sample_dev) for k in RESULT_KEYS], -1))
        run.record(*kept)
    # the sample's record is the harness's, not the program's memory
    run.hold(*kept)
    run.ticks += pcm.shape[0]


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
        run.checksum = int(run.acc.item())
    wall = time.perf_counter() - t0
    return {"frames_per_s": calls * run.frames.shape[0] * run.channels / wall,
            "attempted": calls * run.frames.shape[0] * run.channels}


def finish(run):
    """Free the program's state and cached graph. Returns the sample's
    outputs (pcm [T, S, 160], words [T, S, 5]) and the ticks run."""
    from mbe_tpu_torch import pipeline

    del run.state
    pipeline.clear_compiled()
    pcm = torch.cat(run.out_pcm).cpu().numpy()
    words = torch.cat(run.out_words).cpu().numpy()
    run.out_pcm, run.out_words = [], []
    return pcm, words, run.ticks
