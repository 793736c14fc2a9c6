#!/usr/bin/env python3
"""Example: decode a multi-channel P25 (IMBE 7200x4400) stream to PCM with
the PyTorch port (mbe_tpu_torch; the port of examples/decode_stream.py).

Demonstrates the three usage styles:
  1. one call per frame batch (pipeline.step)
  2. a time-batched sequence (pipeline.run_sequence, replays of the
     compiled step on the card)
  3. continuous streaming with packed-byte input (StreamingDecoder)

Run: python examples/decode_stream_torch.py [--device cuda|cpu]
(on the GPU by default; --device cpu runs the plain PyTorch path).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mbe_tpu_torch import pipeline  # noqa: E402
from mbe_tpu_torch.api import format_process_result  # noqa: E402
from mbe_tpu_torch.models import state  # noqa: E402
from mbe_tpu_torch.parallel.streaming import StreamingDecoder  # noqa: E402

CHANNELS = 64
FRAMES = 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = state.checked_device(ap.parse_args(argv).device)  # no GPU: raises
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 2, (FRAMES, CHANNELS, 8, 23), dtype=np.int32)
    frames_d = torch.as_tensor(frames, device=device)
    seeds = np.arange(1, CHANNELS + 1).astype(np.uint32)

    # --- style 1: per-frame steps ------------------------------------------
    st = state.init_state(CHANNELS, rng_seed=seeds, device=device)
    st, pcm, result, _ = pipeline.step("imbe7200", frames_d[0], st)
    trace = format_process_result({k: v[0].item() for k, v in result.items()})
    print(f"frame 0, channel 0: total_errors="
          f"{int(result['total_errors'][0])} trace={trace!r} "
          f"pcm rms={float(pcm[0].square().mean().sqrt()):.1f}")

    # --- style 2: a sequence over time --------------------------------------
    st = state.init_state(CHANNELS, rng_seed=seeds, device=device)
    st, pcm_seq, results = pipeline.run_sequence("imbe7200", frames_d, st)
    print(f"scan: pcm {tuple(pcm_seq.shape)}, mean errors/frame="
          f"{float(results['total_errors'].float().mean()):.2f}")

    # --- style 3: streaming with packed bytes -------------------------------
    dec = StreamingDecoder("imbe7200", CHANNELS, rng_seed=seeds, device=device)
    n_bits = 8 * 23
    out_blocks = 0
    for t in range(FRAMES):
        bits = frames[t].reshape(CHANNELS, n_bits)
        packed = np.packbits(bits.astype(np.uint8), axis=1)
        for pcm16, res in dec.push(packed):
            out_blocks += 1
    for pcm16, res in dec.flush():
        out_blocks += 1
    print(f"streaming: {out_blocks} PCM blocks of shape (C={CHANNELS}, 160)")


if __name__ == "__main__":
    main()
