"""The streaming entry: `StreamingDecoder.push` in a closed loop.

Packed bytes [C, S] go in from the host each tick, int16 PCM [C, 160] and
the result words come back on the host `depth` ticks later; the next push
starts as soon as the last returned. The pool of packed ticks is held on
the host and cycled. frames_per_s counts the channel-frames whose outputs
the consumer received in the window, over the window's wall seconds.
"""

import time

import numpy as np
import torch

from portbench.reference.runner import RESULT_KEYS
from portbench.traffic import generator


def setup(run, pool):
    """Pack the pool to host bytes, build the decoder and push the warm-up
    ticks (the first captures the tick's CUDA graph)."""
    from mbe_tpu_torch.parallel.streaming import StreamingDecoder

    run.host_pool = np.ascontiguousarray(generator.pack(pool.bits).cpu().numpy())  # [P, C, S]
    packed = torch.from_numpy(run.host_pool)
    run.ref_inputs = lambda: (packed, None)
    run.decoder = StreamingDecoder(run.codec, run.channels, rng_seed=run.pool_seeds,
                                   depth=int(run.traffic["depth"]), int16=True,
                                   unpack=run.traffic["unpack"],
                                   device=run.device)
    run.ticks = 0
    for _ in range(int(run.traffic["warmup_ticks"])):
        consume(run, push(run))


def push(run):
    """One push of the next pool tick: the outputs it yields."""
    packed = run.host_pool[run.ticks % run.host_pool.shape[0]]
    run.ticks += 1
    out = list(run.decoder.push(packed))
    run.counters.setdefault("host_bytes_in", packed.nbytes)
    return out


def consume(run, outs):
    """The consumer: keep the checked sample of each tick received (host
    arrays, made on the decoder's device)."""
    for pcm, res in outs:
        run.took(run.decoder._device)
        run.record(pcm[run.sample], np.stack([res[k][run.sample] for k in RESULT_KEYS], -1))
        run.counters.setdefault("host_bytes_out", pcm.nbytes + sum(res[k].nbytes
                                                                   for k in RESULT_KEYS))
    return len(outs)


def window(run):
    received = pushes = 0
    t0 = time.perf_counter()
    while True:
        run.traced_step(pushes)
        with run.span("push"):
            outs = push(run)
        with run.span("consume"):
            received += consume(run, outs)
        pushes += 1
        if time.perf_counter() - t0 >= run.args.seconds:
            break
    wall = time.perf_counter() - t0
    run.counters["host_bytes_per_frame"] = (
        (run.counters["host_bytes_in"] + run.counters["host_bytes_out"]) / run.channels)
    return {"frames_per_s": received * run.channels / wall,
            "attempted": pushes * run.channels}


def finish(run):
    """Flush the ticks still in flight; free the decoder. Returns the
    sample's outputs (pcm [T, S, 160], words [T, S, 5]) and the number of
    ticks pushed."""
    consume(run, list(run.decoder.flush()))
    del run.decoder
    return np.stack(run.out_pcm), np.stack(run.out_words), run.ticks
