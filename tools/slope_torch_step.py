#!/usr/bin/env python3
"""One codec's step slope at C = 32768 on one NVIDIA GPU, eager and
graphed, by chip_smoke.py's phase 5 with more runs per T.

    python3 tools/slope_torch_step.py [--tree DIR] [--reps 8] [--codec imbe7200] [--soft]
        [--arms eager,graphed]

--tree imports mbe_tpu_torch from another checkout (for example a parent
commit unpacked with `git archive`), so that two commits compare in one
call: run parent, change, change, parent. The eager arm is a Python loop
over pipeline.step; the graphed arm is run_sequence replaying the compiled
step, for a tree that has one (pipeline.CompiledStep). The launch counts
are asserted for the kernels the tree has. Prints each run's wall and
process CPU seconds and the slope, and, for a tree with
utils/profiling.py, device_time of the graphed step (the slope of
replays, each run ended by a readback), with the card's name and power
limit.
"""

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--codec", default="imbe7200", choices=("imbe7200", "ambe2450", "ambe2400"))
    ap.add_argument("--soft", action="store_true", help="soft-decision input")
    ap.add_argument("--arms", default="eager,graphed",
                    help="comma-separated arms to time, each in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slope_torch_step: needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    sys.path.insert(0, str(args.tree.resolve()))
    from mbe_tpu_torch import pipeline
    from mbe_tpu_torch.models.state import init_state
    kernels = {}
    for name, module in (("voiced_sums", "voiced"), ("soft_decode", "softecc"),
                         ("unvoiced_wola", "unvoiced")):
        try:
            kernels[name] = importlib.import_module(f"mbe_tpu_torch.ops.cuda.{module}")
        except ImportError:
            pass  # a tree from before this kernel
    graphed = hasattr(pipeline, "CompiledStep")
    arms = [a for a in args.arms.split(",") if a == "eager" or graphed]
    print(f"tree {args.tree}: {pipeline.__file__}, kernels {sorted(kernels)}, arms {arms}")
    device = torch.device("cuda", 0)
    for arm in arms:
        smoke.phase_scale(pipeline, init_state, kernels, device, args.codec, args.soft,
                          reps=args.reps, arm=arm)
    if graphed:
        from mbe_tpu_torch.utils import profiling
        frames, rel = smoke.scale_frames(pipeline, args.codec, args.soft, device, t_max=1)
        r0 = None if rel is None else rel[0]
        sec = profiling.device_time(
            lambda st: pipeline.step(args.codec, frames[0], st, r0)[0],
            init_state(smoke.SCALE_C, carry_enh=args.codec.startswith("ambe"), device=device),
            iters=24, short_iters=4)
        print(f"device_time graphed {args.codec} {'soft' if args.soft else 'hard'} "
              f"C={smoke.SCALE_C}: {sec * 1e3!r} ms/step [{smoke.card()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
