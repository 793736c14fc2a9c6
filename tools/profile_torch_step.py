#!/usr/bin/env python3
"""Per-layer profile of the PyTorch port's step on one NVIDIA GPU.

    python3 tools/profile_torch_step.py [--channels 32768] [--steps 4]

Wraps each layer of the hard IMBE 7200 step in a torch.profiler
`record_function` range and prints, per step: the wall time without the
profiler, the device kernel count, device busy time and idle share, then
host and device ms per layer. Kernels launched outside a torch op (the
voiced_sums kernel, through ctypes) count in the step's device time but
not in their layer's range.
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
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mbe_tpu_torch import pipeline  # noqa: E402
from mbe_tpu_torch.models import imbe, speech  # noqa: E402
from mbe_tpu_torch.models.state import init_state  # noqa: E402

LAYERS = [
    (imbe, "decode_imbe7200_frame", "bit domain"),
    (imbe, "decode_imbe4400_parms", "parameter decode"),
    (imbe, "spectral_amp_enhance", "synthesis: enhance"),
    (imbe.noise, "comfort_noise", "synthesis: comfort noise"),
    (imbe, "synthesize_speech_core", "synthesis: core"),
    (speech.synth, "render_voiced", "  core: render_voiced"),
    (speech.synth, "unvoiced_fft", "  core: unvoiced_fft"),
]


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 1
    for mod, name, tag in LAYERS:
        _label(mod, name, tag)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    dev = torch.device("cuda", 0)
    c, n = args.channels, args.steps
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 2, (3 * n + 2, c, 8, 23), dtype=np.int8),
                             device=dev)
    state = init_state(c, carry_enh=False, device=dev)

    def run(t0, t1):
        nonlocal state
        for t in range(t0, t1):
            with record_function("step"):
                state, audio, _, _ = pipeline.step("imbe7200", frames[t], state)
            audio.sum()
        torch.cuda.synchronize()

    run(0, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(2, 2 + n)  # the profiler's first window pays its own start-up
    t0 = time.perf_counter()
    run(2 + n, 2 + 2 * n)
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(2 + 2 * n, 2 + 3 * n)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in {"step"} | {tag for _, _, tag in LAYERS}]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3
    print(f"C={c}: wall {wall_ms:.3f} ms/step (no profiler); {len(kernels) / n:.0f} "
          f"kernels/step; device busy {busy_ms:.3f} ms/step; idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for e in prof.key_averages():
        if e.key == "step" or e.key in {tag for _, _, tag in LAYERS}:
            if e.cpu_time_total > 0:
                print(f"{e.key:28s} host {e.cpu_time_total / n / 1e3:8.3f} ms/step "
                      f"(profiled), device {e.device_time_total / n / 1e3:8.3f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
