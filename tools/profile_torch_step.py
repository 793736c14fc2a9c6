#!/usr/bin/env python3
"""Per-layer profile of the PyTorch port's step on one NVIDIA GPU, eager
and graphed.

    python3 tools/profile_torch_step.py [--channels 32768] [--steps 4]
        [--codec imbe7200|ambe2450|ambe2400] [--soft]

Eager arm: wraps each layer of one codec's step (hard, or with --soft
random reliabilities 0..255) in a torch.profiler `record_function` range
and prints, per step: the wall time without the profiler, the device
kernel count, device busy time and idle share, then host and device ms
per layer. Kernels launched outside a torch op (voiced_sums, soft_decode
and unvoiced_wola, through ctypes) count in the step's device time but not
in their layer's range.

Graphed arm: the same step as `pipeline.CompiledStep` replays (a CUDA
graph runs no Python, so it has no layer ranges): wall, device events,
busy ms and idle share per replay, the kernels with the most device time,
and `utils.profiling.device_time` of the graphed step (the slope of
replays ended by a readback). Both arms are traced by
`utils.profiling.trace` into build/traces/.
"""

import argparse
import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mbe_tpu_torch import pipeline  # noqa: E402
from mbe_tpu_torch.models import ambe, imbe, speech  # noqa: E402
from mbe_tpu_torch.models.state import init_state  # noqa: E402
from mbe_tpu_torch.utils import profiling  # noqa: E402

TRACES = Path(__file__).resolve().parent.parent / "build" / "traces"

FRAME_SHAPE = {"imbe7200": (8, 23), "ambe2450": (4, 24), "ambe2400": (4, 24)}
CORE = [
    (speech.synth, "render_voiced", "  core: render_voiced"),
    (speech.synth, "unvoiced_fft", "  core: unvoiced_fft"),
]


def layers(codec):
    """(module, function, tag) of each layer of `codec`'s step."""
    if codec == "imbe7200":
        return [
            (imbe, "decode_imbe7200_frame", "bit domain"),
            (imbe, "decode_imbe4400_parms", "parameter decode"),
            (imbe, "spectral_amp_enhance", "synthesis: enhance"),
            (imbe.noise, "comfort_noise", "synthesis: comfort noise"),
            (imbe, "synthesize_speech_core", "synthesis: core"),
        ] + CORE
    return [
        (ambe, "decode_ambe3600_frame", "bit domain"),
        (ambe, f"decode_{codec}_parms", "parameter decode"),
        (ambe, "spectral_amp_enhance", "synthesis: enhance"),
        (ambe.noise, "comfort_noise", "synthesis: comfort noise"),
        (ambe, "synthesize_speech_core", "synthesis: core"),
        (ambe.synth, "render_tone", "synthesis: tones"),
    ] + CORE


def _label(mod, name, tag):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(tag):
            return fn(*args, **kwargs)

    setattr(mod, name, wrapped)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--codec", default="imbe7200", choices=tuple(FRAME_SHAPE))
    ap.add_argument("--soft", action="store_true", help="soft-decision input")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 1
    tags = layers(args.codec)
    for mod, name, tag in tags:
        _label(mod, name, tag)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    dev = torch.device("cuda", 0)
    c, n = args.channels, args.steps
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 2, (3 * n + 2, c, *FRAME_SHAPE[args.codec]),
                                          dtype=np.int8), device=dev)
    rel = (torch.as_tensor(rng.integers(0, 256, frames.shape, dtype=np.uint8), device=dev)
           if args.soft else None)
    state = init_state(c, carry_enh=args.codec.startswith("ambe"), device=dev)

    def run(t0, t1):
        nonlocal state
        for t in range(t0, t1):
            with record_function("step"):
                state, audio, _, _ = pipeline.step(args.codec, frames[t], state,
                                                   None if rel is None else rel[t])
            audio.sum()
        torch.cuda.synchronize()

    run(0, 2)
    with profiling.trace(TRACES):
        run(2, 2 + n)  # the profiler's first window pays its own start-up
    t0 = time.perf_counter()
    run(2 + n, 2 + 2 * n)
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profiling.trace(TRACES) as prof:
        run(2 + 2 * n, 2 + 3 * n)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in {"step"} | {tag for _, _, tag in tags}]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3
    path = f"{args.codec} C={c} {'soft' if args.soft else 'hard'}"
    print(f"{path} eager: wall {wall_ms:.3f} ms/step (no profiler); {len(kernels) / n:.0f} "
          f"kernels/step; device busy {busy_ms:.3f} ms/step; idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for e in prof.key_averages():
        if e.key == "step" or e.key in {tag for _, _, tag in tags}:
            if e.cpu_time_total > 0:
                print(f"{e.key:28s} host {e.cpu_time_total / n / 1e3:8.3f} ms/step "
                      f"(profiled), device {e.device_time_total / n / 1e3:8.3f} ms/step")

    # graphed arm: the same step as CompiledStep replays
    compiled = pipeline.CompiledStep(args.codec, init_state(
        c, carry_enh=args.codec.startswith("ambe"), device=dev), soft=args.soft)

    def replay(t0, t1):
        for t in range(t0, t1):
            compiled(frames[t], None if rel is None else rel[t])
        torch.cuda.synchronize()

    replay(0, 2)
    t0 = time.perf_counter()
    replay(2, 2 + n)
    g_wall = (time.perf_counter() - t0) / n * 1e3
    with profiling.trace(TRACES) as prof:
        replay(2 + n, 2 + 2 * n)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    g_busy = sum(e.time_range.elapsed_us() for e in events) / n / 1e3
    print(f"{path} graphed: wall {g_wall:.3f} ms/replay (no profiler); {len(events) / n:.0f} "
          f"device events/replay; device busy {g_busy:.3f} ms/replay; idle share "
          f"{1 - g_busy / g_wall:.3f}")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / n / 1e3
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:8.4f} ms/replay  {name[:90]}")
    frame, r0 = frames[0], None if rel is None else rel[0]
    sec = profiling.device_time(lambda st: pipeline.step(args.codec, frame, st, r0)[0],
                                init_state(c, carry_enh=args.codec.startswith("ambe"),
                                           device=dev), iters=24, short_iters=4)
    print(f"{path} graphed: device_time {sec * 1e3:.4f} ms/step (slope of replays)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
