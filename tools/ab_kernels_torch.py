#!/usr/bin/env python3
"""The voiced (B1) and unvoiced (B3) kernels of this checkout against those
of another checkout, in one process on one NVIDIA GPU.

    python3 tools/ab_kernels_torch.py --tree trees/parent [--reps 50] [--c 16 1000 32768]

--tree is a checkout to compare with, for example the parent commit
unpacked with `git archive` into the git-ignored trees/. For each kernel
source of both checkouts it prints ptxas's registers, shared memory and
spills (nvcc -Xptxas -v) and, where the source exports it, the runtime's
resident blocks per SM. Then, at each channel count, each library's
output against the plain PyTorch version (max |err| / max |ref|) and its
time by CUDA events, taken in turns: other, this, this, other. The inputs
are chip_smoke.py's. Prints the card's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mbe_tpu_torch.ops.cuda import build, unvoiced, voiced  # noqa: E402

# kernel: (source, C entry point, pointer arguments)
KERNELS = {"voiced_sums": ("voiced.cu", "mbe_voiced_sums", 14),
           "unvoiced_wola": ("unvoiced.cu", "mbe_unvoiced_wola", 13)}


def ptxas(source, tag):
    """ptxas's resource lines for `source` (compiled to a cubin in build/)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"ptxas_{tag}_{source.stem}.cubin"
    proc = subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return [line.strip() for line in proc.stderr.splitlines()
            if "Used" in line or "spill" in line]


def entry(source, symbol, npointers):
    lib = build.load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * npointers + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = getattr(lib, f"{symbol}_blocks_per_sm", None)
    if blocks is not None:
        blocks.restype = ctypes.c_int
        blocks = blocks()
    return fn, blocks


def check(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def voiced_case(smoke, c, device):
    """(launch(fn), error()) for voiced_sums at C = c: error() is the last
    launch's max |err| / max |ref| against the plain version."""
    args = smoke.kernel_inputs(c, device)
    out = torch.empty((160, c), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(fn):
        check(fn(*(x.data_ptr() for x in args), out.data_ptr(), c, stream))

    def error():
        ref = voiced.voiced_sums_reference(*args)
        return ((out - ref).abs().max() / ref.abs().max()).item()

    return launch, error


def unvoiced_case(smoke, c, device):
    """As voiced_case, for unvoiced_wola (the worse of its two outputs)."""
    args = smoke.unvoiced_inputs(c, device)
    consts = (unvoiced._cos_table(device), *unvoiced._windows(device))
    outs = (torch.empty((160, c), dtype=torch.float32, device=device),
            torch.empty((128, c), dtype=torch.float32, device=device))
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(fn):
        check(fn(*(x.data_ptr() for x in (*args, *consts, *outs)), c, stream))

    def error():
        ref = unvoiced.unvoiced_wola_reference(*args)
        return max(((o - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, ref))

    return launch, error


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--c", type=int, nargs="+", default=[16, 1000, 32768])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels_torch: needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    device = torch.device("cuda", 0)
    trees = {"other": args.tree.resolve(), "this": ROOT}
    cases = {"voiced_sums": voiced_case, "unvoiced_wola": unvoiced_case}

    for name, (src, symbol, npointers) in KERNELS.items():
        fns = {}
        for tag, tree in trees.items():
            source = tree / "mbe_tpu_torch" / "csrc" / src
            for line in ptxas(source, tag):
                print(f"ptxas {name} {tag} ({source}): {line}")
            fns[tag], blocks = entry(source, symbol, npointers)
            print(f"occupancy {name} {tag}: resident blocks per SM "
                  f"{'not exported' if blocks is None else blocks}")
        for c in args.c:
            launch, error = cases[name](smoke, c, device)
            times = {tag: [] for tag in trees}
            for tag in ("other", "this", "this", "other"):
                times[tag].append(smoke.cuda_ms(lambda: launch(fns[tag]), args.reps))
            for tag in trees:
                launch(fns[tag])
                torch.cuda.synchronize()
                print(f"ab {name} C={c} {tag}: ms {times[tag]!r} (mean "
                      f"{sum(times[tag]) / 2!r}), rel err vs plain {error()!r}")
    print(smoke.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
