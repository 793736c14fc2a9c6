#!/usr/bin/env python3
"""The voiced (B1), soft-decode (B2) and unvoiced (B3) kernels of this
checkout against those of another checkout, in one process on one NVIDIA GPU.

    python3 tools/ab_kernels_torch.py --tree trees/parent [--reps 50] [--c 16 1000 32768]
        [--kernels voiced_sums soft_decode unvoiced_wola]

--tree is a checkout to compare with, for example the parent commit
unpacked with `git archive` into the git-ignored trees/. For each kernel
source of both checkouts it prints ptxas's registers, shared memory and
spills (nvcc -Xptxas -v) and, where the source exports it, the runtime's
resident blocks per SM. Then, at each channel count (B1, B3) or row count
(B2: Golay and standard Hamming at SOFT_ROWS), each library's output
against the plain PyTorch version (max |err| / max |ref|; for B2 the
number of keys that differ) and its time by CUDA events, taken in turns:
other, this, this, other. The inputs are chip_smoke.py's. Each tree's B2
kernel reads that tree's own codebook table, so the other tree's wrapper
module is imported by path for its `_kernel_tables`; for B2 each tree's
wrapper `soft_decode_keys` is also timed on the host, in the same turns.
Prints the card's name and power limit.
"""

import argparse
import ctypes
import importlib
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mbe_tpu_torch.ops import ecc  # noqa: E402
from mbe_tpu_torch.ops.cuda import build, softecc, unvoiced, voiced  # noqa: E402

# kernel: (source, C entry point, pointer arguments, int arguments)
KERNELS = {"voiced_sums": ("voiced.cu", "mbe_voiced_sums", 14, 1),
           "soft_decode": ("softecc.cu", "mbe_soft_decode_keys", 6, 2),
           "unvoiced_wola": ("unvoiced.cu", "mbe_unvoiced_wola", 13, 1)}
# B2's row counts: the C0 launch and the 98304-row launches of a soft
# imbe7200 step at C = 32768
SOFT_ROWS = (32768, 98304)
HOST_ROWS = 16     # B2's host-time rows: the device work is far shorter than the call


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
            if "Used" in line or "spill" in line or "wgmma" in line]


def entry(source, symbol, npointers, nints):
    lib = build.load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * npointers + [ctypes.c_int] * nints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = getattr(lib, f"{symbol}_blocks_per_sm", None)
    if blocks is not None:
        blocks.restype = ctypes.c_int
        blocks = blocks()
    return fn, blocks


def check(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def other_softecc(tree):
    """The B2 wrapper module of checkout `tree`, imported under another
    package name beside this checkout's."""
    name = "mbe_tpu_torch_other"
    spec = importlib.util.spec_from_file_location(
        name, tree / "mbe_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(tree / "mbe_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.ops.cuda.softecc")


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


def soft_entry(fn, module, device):
    """The B2 C entry `fn` of one tree, bound to the codebook tables of that
    tree's wrapper `module`: call(code, bits, rel, idx_hard, key, rows,
    stream), pointers as ints."""
    tables = {code: module._kernel_tables(code, device) for code in ("golay", "hamstd")}

    def call(code, bits, rel, idx, key, rows, stream):
        tab, packed = tables[code]
        return fn(bits, rel, idx, tab.data_ptr(), packed.data_ptr(), key, rows,
                  module.CODES[code].kernel_id, stream)

    return call


def soft_case(smoke, size, device):
    """As voiced_case, for soft_decode at size = (code, rows), each tree's
    entry from soft_entry; error() is the number of keys that differ from
    the plain version's."""
    code, rows = size
    args = smoke.soft_inputs(ecc, softecc, code, rows, device)
    key = torch.empty((rows,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(fn):
        check(fn(code, *(x.data_ptr() for x in (*args, key)), rows, stream))

    def error():
        step = smoke.PLAIN_ROWS
        ref = torch.cat([softecc.soft_decode_keys_reference(*(x[lo:lo + step] for x in args), code)
                         for lo in range(0, rows, step)])
        return int((key != ref).sum().item())

    return launch, error


def host_us(module, args, code, reps):
    """Host microseconds per call of `module.soft_decode_keys`: the wall
    time of `reps` calls queued with no synchronization between them, the
    least over 5 batches (the host's jitter only adds)."""
    module.soft_decode_keys(*args, code)
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            module.soft_decode_keys(*args, code)
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / reps * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--c", type=int, nargs="+", default=[16, 1000, 32768])
    ap.add_argument("--kernels", nargs="+", choices=tuple(KERNELS), default=tuple(KERNELS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels_torch: needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    device = torch.device("cuda", 0)
    trees = {"other": args.tree.resolve(), "this": ROOT}
    cases = {"voiced_sums": voiced_case, "soft_decode": soft_case,
             "unvoiced_wola": unvoiced_case}
    sizes = {"voiced_sums": args.c, "unvoiced_wola": args.c,
             "soft_decode": [(code, r) for r in SOFT_ROWS for code in ("golay", "hamstd")]}
    turns = ("other", "this", "this", "other")
    modules = {"other": other_softecc(trees["other"]), "this": softecc}  # B2's wrappers

    for name in args.kernels:
        src, symbol, npointers, nints = KERNELS[name]
        fns = {}
        for tag, tree in trees.items():
            source = tree / "mbe_tpu_torch" / "csrc" / src
            for line in ptxas(source, tag):
                print(f"ptxas {name} {tag} ({source}): {line}")
            fns[tag], blocks = entry(source, symbol, npointers, nints)
            if name == "soft_decode":
                fns[tag] = soft_entry(fns[tag], modules[tag], device)
            print(f"occupancy {name} {tag}: resident blocks per SM "
                  f"{'not exported' if blocks is None else blocks}")
        what = "keys differing from plain" if name == "soft_decode" else "rel err vs plain"
        for size in sizes[name]:
            launch, error = cases[name](smoke, size, device)
            times = {tag: [] for tag in trees}
            for tag in turns:
                times[tag].append(smoke.cuda_ms(lambda: launch(fns[tag]), args.reps))
            for tag in trees:
                launch(fns[tag])
                torch.cuda.synchronize()
                print(f"ab {name} {size} {tag}: ms {times[tag]!r} (mean "
                      f"{sum(times[tag]) / 2!r}), {what} {error()!r}")
        if name == "soft_decode":
            for code in ("golay", "hamstd"):
                inputs = smoke.soft_inputs(ecc, softecc, code, HOST_ROWS, device)
                host = {tag: [] for tag in trees}
                for tag in turns:
                    host[tag].append(host_us(modules[tag], inputs, code, args.reps))
                for tag in trees:
                    print(f"host soft_decode_keys {code} R={HOST_ROWS} {tag}: us per call "
                          f"{host[tag]!r}")
    print(smoke.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
