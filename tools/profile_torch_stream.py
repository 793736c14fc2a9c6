#!/usr/bin/env python3
"""Where the PyTorch port's StreamingDecoder spends a tick, on one GPU.

    python3 tools/profile_torch_stream.py [--channels 32768] [--ticks 8]
        [--codec imbe7200|imbe7100|ambe2450|ambe2400] [--depth 2]

Random packed frames (numpy.random.default_rng(0)). Prints, each over
`--ticks` ticks after a warm-up of depth + 1 ticks:
  1. wall ms per tick of StreamingDecoder.push (device unpack; a captured
     tick replayed), of an eager loop of pipeline.step + float_to_short
     and of a graphed loop of CompiledStep(int16=True) replays, each with
     the PCM read back every tick, and of run_sequence(int16=True) (graphed)
     with the PCM read back at the end, in the order stream, loop,
     graphed loop, sequence, sequence, graphed loop, loop, stream;
  2. per tick, the host ms of the decoder's launch (upload, replay, the
     non-blocking readback and its event) and of its collect (the wait on
     the event, the copy out of the pinned buffer);
  3. a utils.profiling.trace table of the streaming ticks and of both
     loops: the host calls with the most self CPU time, the device events
     (kernels and copies), busy ms and idle share per tick.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mbe_tpu_torch import pipeline  # noqa: E402
from mbe_tpu_torch.models.state import init_state  # noqa: E402
from mbe_tpu_torch.ops.cuda import softecc, unvoiced, voiced  # noqa: E402
from mbe_tpu_torch.ops.synth import float_to_short  # noqa: E402
from mbe_tpu_torch.parallel.streaming import StreamingDecoder  # noqa: E402
from mbe_tpu_torch.utils import profiling  # noqa: E402

TRACES = Path(__file__).resolve().parent.parent / "build" / "traces"


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_summary(prof, wall_ms, n):
    """Device events, busy ms and idle share per tick, over n ticks that
    took wall_ms."""
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3  # us -> ms
    return (f"{len(events) / n:.0f} device events, busy {busy / n!r} ms, wall "
            f"{wall_ms / n!r} ms, idle share {1 - busy / wall_ms!r} per tick")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--channels", type=int, default=32768)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--codec", default="imbe7200", choices=pipeline.CODECS)
    ap.add_argument("--depth", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_stream: no CUDA device", file=sys.stderr)
        return 1
    for k in (voiced, softecc, unvoiced):
        k.load_library()
    c, n, depth = args.channels, args.ticks, args.depth
    rows, cols = pipeline.FRAME_SHAPES[args.codec]
    warm = depth + 1
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (warm + n, c, rows * cols)).astype(np.uint8)
    packed = np.packbits(bits, axis=-1)
    frames = torch.as_tensor(bits.reshape(warm + n, c, rows, cols), dtype=torch.int32,
                             device="cuda")
    seeds = np.arange(1, c + 1, dtype=np.uint32)
    print(f"{card()}; torch {torch.__version__}; {args.codec} C={c} depth={depth}")

    def stream():
        dec = StreamingDecoder(args.codec, c, rng_seed=seeds, depth=depth)
        for t in range(warm):
            list(dec.push(packed[t]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(warm, warm + n):
            list(dec.push(packed[t]))
        list(dec.flush())
        return (time.perf_counter() - t0) / n * 1e3

    def loop():
        state = init_state(c, rng_seed=seeds)
        for t in range(warm):
            state, audio, _, _ = pipeline.step(args.codec, frames[t], state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(warm, warm + n):
            state, audio, _, _ = pipeline.step(args.codec, frames[t], state)
            float_to_short(audio).cpu()
        return (time.perf_counter() - t0) / n * 1e3

    def graphed_loop():
        compiled = pipeline.CompiledStep(args.codec, init_state(c, rng_seed=seeds), int16=True)
        for t in range(warm):
            compiled(frames[t])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(warm, warm + n):
            _, audio, _ = compiled(frames[t])
            audio.cpu()
        return (time.perf_counter() - t0) / n * 1e3

    def sequence():
        state = init_state(c, rng_seed=seeds)
        state, _, _ = pipeline.run_sequence(args.codec, frames[:warm], state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pcm, _ = pipeline.run_sequence(args.codec, frames[warm:], state, int16=True)
        pcm.cpu()
        return (time.perf_counter() - t0) / n * 1e3

    arms = {"stream": stream, "loop": loop, "graphed_loop": graphed_loop, "sequence": sequence}
    walls = {name: [] for name in arms}
    for name in ("stream", "loop", "graphed_loop", "sequence", "sequence", "graphed_loop", "loop",
                 "stream"):
        walls[name].append(arms[name]())
    print(f"wall ms per tick: {walls!r}")

    # host ms of the decoder's launch and collect, tick by tick
    dec = StreamingDecoder(args.codec, c, rng_seed=seeds, depth=depth)
    for t in range(warm):
        list(dec.push(packed[t]))
    torch.cuda.synchronize()
    launch, collect = [], []
    for t in range(warm, warm + n):
        t0 = time.perf_counter()
        dec._launch(packed[t])
        t1 = time.perf_counter()
        while len(dec._inflight) > depth:
            dec._collect()
        launch.append((t1 - t0) * 1e3)
        collect.append((time.perf_counter() - t1) * 1e3)
    list(dec.flush())
    print(f"host ms per tick: launch {launch!r}; collect {collect!r}")

    with profiling.trace(TRACES):
        loop()  # the profiler's first window pays its own start-up
    for name in ("stream", "loop", "graphed_loop"):
        fn = arms[name]
        torch.cuda.synchronize()
        with profiling.trace(TRACES) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the profiled window holds the warm-up too: per tick over all of it
        print(f"profile {name}: {device_summary(prof, wall * 1e3, warm + n)}")
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15,
                                        max_name_column_width=48))
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
