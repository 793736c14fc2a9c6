#!/usr/bin/env python3
"""The hand-written kernels of this checkout against those of another
checkout, in one process on one NVIDIA GPU: every counted entry point of
the kernel registry (mbe_tpu_torch/ops/cuda/build.KERNELS), that is B1
(voiced_sums), B2 (soft_decode_keys), B3 (unvoiced_wola), S (comfort_noise,
lcg_buffer, tone_render) and lane_select.

    python3 tools/ab_kernels_torch.py --tree trees/parent [--reps 50] [--c 16 1000 32768]
        [--kernels mbe_voiced_sums mbe_soft_decode_keys ...]

--tree is a checkout to compare with, for example the parent commit
unpacked with `git archive` into the git-ignored trees/. For each kernel
source of both checkouts it prints ptxas's registers, shared memory and
spills (nvcc -Xptxas -v) and, where the source exports it, the runtime's
resident blocks per SM. Then, for each entry point and size, this
checkout's binding is called once on chip_smoke.py's inputs with its
launch recorded: at each channel count (B1, B3, S), at each row count of
B2 (Golay and standard Hamming at SOFT_ROWS), and for each lane_select call
of one IMBE and one AMBE step at C = 32768. The recorded launch is
replayed through each checkout's library (the other one's built from its
source, bound with this checkout's argument types), timed by CUDA events
in turns other, this, this, other, and each library's outputs are held
against the plain form's: max |err| / max |ref| over the float outputs,
and the number of other elements that differ (B2: keys). Each tree's B2
kernel reads that tree's own codebook table, so the other tree's wrapper
module is imported by path for its `_kernel_tables`; for B2 each tree's
wrapper `soft_decode_keys` is also timed on the host, in the same turns.
An entry point of the registry with no case here stops the run. Prints
the card's name and power limit.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mbe_tpu_torch import pipeline  # noqa: E402
from mbe_tpu_torch.models import state  # noqa: E402
from mbe_tpu_torch.ops import ecc, noise, synth  # noqa: E402
from mbe_tpu_torch.ops.cuda import build, select, softecc, unvoiced, voiced  # noqa: E402

# B2's row counts: the C0 launch and the 98304-row launches of a soft
# imbe7200 step at C = 32768
SOFT_ROWS = (32768, 98304)
HOST_ROWS = 16     # B2's host-time rows: the device work is far shorter than the call
# S's entry points by the dispatcher that calls each (chip_smoke.sources_inputs' keys)
S_DISPATCH = {"mbe_comfort_noise": "comfort_noise",
              "mbe_lcg_buffer": "generate_noise_with_overlap",
              "mbe_tone_render": "render_tone"}


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


def blocks_per_sm(kernel):
    """The entry point's resident blocks per SM, where its source exports
    `<symbol>_blocks_per_sm`."""
    fn = getattr(build.load(kernel.source), f"{kernel.symbol}_blocks_per_sm", None)
    if fn is None:
        return "not exported"
    fn.restype = build.INT
    return fn()


def other_package(tree):
    """The package of checkout `tree`, imported under another name beside
    this checkout's."""
    name = "mbe_tpu_torch_other"
    spec = importlib.util.spec_from_file_location(
        name, tree / "mbe_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(tree / "mbe_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return name


def cases(smoke, symbol, sizes_c, device):
    """[(size, call, plain)] of entry point `symbol`: call() runs this
    checkout's binding (one launch), plain() its plain form on the same
    inputs."""
    out = []
    if symbol in ("mbe_voiced_sums", "mbe_unvoiced_wola"):
        inputs, module, name = ((smoke.kernel_inputs, voiced, "voiced_sums")
                                if symbol == "mbe_voiced_sums"
                                else (smoke.unvoiced_inputs, unvoiced, "unvoiced_wola"))
        for c in sizes_c:
            x = inputs(c, device)
            out.append((c, partial(getattr(module, name), *x),
                        partial(getattr(module, f"{name}_reference"), *x)))
    elif symbol == "mbe_soft_decode_keys":
        for rows in SOFT_ROWS:
            for code in ("golay", "hamstd"):
                x = smoke.soft_inputs(ecc, softecc, code, rows, device)
                chunks = [[a[lo:lo + smoke.PLAIN_ROWS] for a in x]
                          for lo in range(0, rows, smoke.PLAIN_ROWS)]
                out.append(((code, rows), partial(softecc.soft_decode_keys, *x, code),
                            lambda chunks=chunks, code=code: torch.cat(
                                [softecc.soft_decode_keys_reference(*a, code) for a in chunks])))
    elif symbol in S_DISPATCH:
        name = S_DISPATCH[symbol]
        module = synth if name == "render_tone" else noise
        for c in sizes_c:
            x = smoke.sources_inputs(noise, c, device)[name]
            out.append((c, partial(getattr(module, name), *x),
                        partial(getattr(module, f"{name}_reference"), *x)))
    elif symbol == "mbe_lane_select":
        def parms(leaves):
            return leaves if isinstance(leaves, int) else state.Parms(
                **dict(zip(state.PARMS_FIELDS, leaves)))

        for codec, soft in (("imbe7200", False), ("ambe2450", True)):
            for i, sel in enumerate(smoke.recorded_selects(pipeline, select, device, codec, soft)):
                plain = [([(m, parms(t)) for m, t in cs], parms(d)) for cs, d in sel]
                out.append(((codec, i), partial(select.lane_select, sel),
                            lambda p=plain: [[getattr(o, k) for k in state.PARMS_FIELDS]
                                             for o in state.select_many_reference(p)]))
    else:
        raise SystemExit(f"ab_kernels_torch: no case for the registered entry point {symbol}")
    return out


def recorded(kernel, call):
    """call() with `kernel`'s launches recorded: (its outputs, the device
    and arguments of its one launch)."""
    seen, launch = [], kernel.launch
    kernel.launch = lambda device, *args: (seen.append((device, args)), launch(device, *args))
    try:
        out = call()
    finally:
        del kernel.launch
    if len(seen) != 1:
        raise RuntimeError(f"{kernel.symbol}: {len(seen)} launches in one call, not 1")
    return out, seen[0]


def tensors(tree):
    """The tensors of an output tree of nested tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in tensors(sub)]


def error(out, ref):
    """(max |err| / max |ref| over the float outputs, elements that differ
    over the others)."""
    rel, differ = 0.0, 0
    for o, r in zip(tensors(out), tensors(ref)):
        if o.dtype.is_floating_point:
            scale = r.abs().max().item() or 1.0
            rel = max(rel, (o - r).abs().max().item() / scale)
        else:
            differ += int((o != r).sum().item())
    return rel, differ


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
    counted = [k for k in build.KERNELS if k.counter is not None]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--c", type=int, nargs="+", default=[16, 1000, 32768])
    ap.add_argument("--kernels", nargs="+", choices=[k.symbol for k in counted],
                    default=[k.symbol for k in counted])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels_torch: needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    device = torch.device("cuda", 0)
    tree = args.tree.resolve()
    turns = ("other", "this", "this", "other")
    other = other_package(tree)
    modules = {"other": importlib.import_module(f"{other}.ops.cuda.softecc"),
               "this": softecc}  # B2's wrappers, each with its codebook tables

    compiled = set()
    for kernel in (k for k in counted if k.symbol in args.kernels):
        kernels = {"other": dataclasses.replace(kernel, counter=None,
                                                source=tree / "mbe_tpu_torch" / "csrc"
                                                / kernel.source.name),
                   "this": kernel}
        for tag, k in kernels.items():
            if k.source not in compiled:
                compiled.add(k.source)
                for line in ptxas(k.source, tag):
                    print(f"ptxas {kernel.source.name} {tag} ({k.source}): {line}")
            print(f"occupancy {kernel.symbol} {tag}: resident blocks per SM {blocks_per_sm(k)}")
        for size, call, plain in cases(smoke, kernel.symbol, args.c, device):
            out, (dev, launch_args) = recorded(kernel, call)
            ref = plain()
            per_tag = {}
            for tag in kernels:
                per_tag[tag] = list(launch_args)
                if kernel.symbol == "mbe_soft_decode_keys":
                    per_tag[tag][3:5] = modules[tag]._kernel_tables(size[0], device)
            times = {tag: [] for tag in kernels}
            for tag in turns:
                times[tag].append(smoke.cuda_ms(
                    lambda: kernels[tag].launch(dev, *per_tag[tag]), args.reps))
            for tag in kernels:
                kernels[tag].launch(dev, *per_tag[tag])
                torch.cuda.synchronize()
                rel, differ = error(out, ref)
                print(f"ab {kernel.symbol} {size} {tag}: ms {times[tag]!r} (mean "
                      f"{sum(times[tag]) / 2!r}), rel err vs plain {rel!r}, elements differing "
                      f"{differ}")
        if kernel.symbol == "mbe_soft_decode_keys":
            for code in ("golay", "hamstd"):
                inputs = smoke.soft_inputs(ecc, softecc, code, HOST_ROWS, device)
                host = {tag: [] for tag in kernels}
                for tag in turns:
                    host[tag].append(host_us(modules[tag], inputs, code, args.reps))
                for tag in kernels:
                    print(f"host soft_decode_keys {code} R={HOST_ROWS} {tag}: us per call "
                          f"{host[tag]!r}")
    print(smoke.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
