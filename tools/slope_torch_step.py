#!/usr/bin/env python3
"""One codec's step slope at C = 32768 on one NVIDIA GPU, by
chip_smoke.py's phase 5 with more runs per T.

    python3 tools/slope_torch_step.py [--tree DIR] [--reps 8] [--codec imbe7200] [--soft]

--tree imports mbe_tpu_torch from another checkout (for example a parent
commit unpacked with `git archive`), so that two commits compare in one
call: run parent, change, change, parent. The launch counts are asserted
for the kernels the tree has (a tree from before soft_decode or
unvoiced_wola runs the hard imbe7200 path without them). Prints each
run's wall and process CPU seconds and the slope, with the card's name
and power limit.
"""

import argparse
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
    print(f"tree {args.tree}: {pipeline.__file__}, kernels {sorted(kernels)}")
    smoke.phase_scale(pipeline, init_state, kernels, torch.device("cuda", 0), args.codec,
                      args.soft, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
