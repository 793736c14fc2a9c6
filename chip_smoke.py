#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (mbe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each asserting (any failure ends the run with a nonzero exit):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the voiced_sums kernel from mbe_tpu_torch/csrc/voiced.cu;
  3. the kernel against its plain PyTorch version on the card at
     C = 16, 1000 and 32768: max |err| / max |ref| < 2e-4, both timed;
  4. the golden vectors through the port's pipeline on the card:
     e2e_imbe7200 (C=16, T=40) by `step` and long_imbe7200 (C=4, T=200)
     by `run_sequence` — imbe_d bits, error counts and flags bit-exact,
     >= 60 dB PCM SNR per frame and lane, >= 60 dB for the int16 stream;
  5. the main path at full width: C = 32768 channels of random hard
     frames through `run_sequence` at T = 8 and T = 48; ms per frame step
     is the slope between the two (it cancels the fixed per-run cost).

The kernel launch counter is zeroed just before phase 5 and read just
after it. The last lines are the kernels JSON, the card, and
{"ok": true, "device": {...}}. There is no CPU path: without a CUDA
device, or without the package beside this script, it exits nonzero.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
VECTORS = ROOT / "tests" / "vectors"
SEED = 0
KERNEL_TOL = 2e-4      # relative to max |ref|: the recurrence drift bound
SNR_MIN_DB = 60.0      # the reference's float-synthesis bar (tests/test_e2e.py)
KERNEL_C = (16, 1000, 32768)
SCALE_C = 32768        # bench.py's default channel count
SCALE_T = (8, 48)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    p_sig = np.mean(ref ** 2)
    p_err = np.mean(err ** 2)
    if p_sig < 1e-12:
        return np.inf if p_err < 1e-12 else -np.inf
    return 10.0 * np.log10(p_sig / max(p_err, 1e-30))


def cuda_ms(fn, reps):
    """Mean ms per call over `reps` calls, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(c, device):
    """Random voiced_sums inputs in the ranges of tests/test_pallas.py."""
    rng = np.random.default_rng(SEED)

    def u(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=device)

    bank = [u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c))]
    bank += [u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c))]
    interp = [u(0, 4, (7, c)), u(-0.02, 0.02, (7, c)), u(0, 6, (7, c)),
              u(0, 2, (7, c)), u(-2e-3, 2e-3, (7, c))]
    return bank + interp + [u(0, 1, (160,)), u(0, 1, (160,))]


def phase_kernel(voiced, device):
    worst_abs = 0.0
    for c in KERNEL_C:
        args = kernel_inputs(c, device)
        out = voiced.voiced_sums(*args)
        torch.cuda.synchronize()
        ref = voiced.voiced_sums_reference(*args)
        abs_err = (out - ref).abs().max().item()
        rel = abs_err / ref.abs().max().item()
        ms = cuda_ms(lambda: voiced.voiced_sums(*args), 20)
        plain_ms = cuda_ms(lambda: voiced.voiced_sums_reference(*args), 5)
        print(f"kernel voiced_sums C={c}: max_abs_err={abs_err!r} rel={rel!r} "
              f"kernel {ms!r} ms, plain {plain_ms!r} ms")
        assert rel < KERNEL_TOL, f"C={c}: relative error {rel} >= {KERNEL_TOL}"
        worst_abs = max(worst_abs, abs_err)
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms)


def check_outputs(name, vec, pcm, res, dbits=None):
    """Bit-exact counts/flags (and imbe_d), per-frame and int16 SNR."""
    from mbe_tpu_torch.ops.synth import float_to_short
    got = np.stack([res[k].cpu().numpy() for k in
                    ("c0_errors", "protected_errors", "c4_errors", "total_errors")],
                   axis=-1)
    np.testing.assert_array_equal(got, vec["res"], err_msg=f"{name} error counts")
    np.testing.assert_array_equal(res["flags"].cpu().numpy(), vec["flags"],
                                  err_msg=f"{name} flags")
    if dbits is not None:
        np.testing.assert_array_equal(dbits, vec["dbits"], err_msg=f"{name} imbe_d")
    pcm_np = pcm.cpu().numpy()
    T, C = pcm_np.shape[:2]
    snrs = np.array([[snr_db(vec["pcm"][t, i], pcm_np[t, i]) for i in range(C)]
                     for t in range(T)])
    s16 = snr_db(vec["pcm16"].astype(np.float64),
                 float_to_short(pcm).cpu().numpy().astype(np.float64))
    print(f"golden {name}: T={T} C={C} bit-exact; per-frame SNR worst "
          f"{float(snrs.min())!r} dB, median {float(np.median(snrs))!r} dB; int16 {float(s16)!r} dB")
    assert snrs.min() >= SNR_MIN_DB, f"{name}: worst frame {snrs.min()} dB"
    assert s16 >= SNR_MIN_DB, f"{name}: int16 stream {s16} dB"


def phase_goldens(pipeline, init_state, voiced, device):
    vec = dict(np.load(VECTORS / "e2e_imbe7200.npz"))
    T, C = vec["frames"].shape[:2]
    state = init_state(C, rng_seed=vec["seeds"], device=device)
    frames = torch.as_tensor(vec["frames"], device=device)
    before = voiced.LAUNCHES
    pcm, res, dbits = [], [], []
    for t in range(T):
        state, audio, r, d = pipeline.step("imbe7200", frames[t], state)
        pcm.append(audio)
        res.append(r)
        dbits.append(d.cpu().numpy())
    assert voiced.LAUNCHES - before >= T, "e2e: voiced kernel not launched per frame"
    check_outputs("e2e_imbe7200", vec, torch.stack(pcm),
                  {k: torch.stack([r[k] for r in res]) for k in res[0]},
                  np.stack(dbits))

    vec = dict(np.load(VECTORS / "long_imbe7200.npz"))
    T, C = vec["frames"].shape[:2]
    state = init_state(C, rng_seed=vec["seeds"], device=device)
    before = voiced.LAUNCHES
    state, pcm, res = pipeline.run_sequence(
        "imbe7200", torch.as_tensor(vec["frames"], device=device), state)
    assert voiced.LAUNCHES - before >= T, "long: voiced kernel not launched per frame"
    check_outputs("long_imbe7200", vec, pcm, res)


def phase_scale(pipeline, init_state, voiced, device):
    rng = np.random.default_rng(SEED)
    t_max = max(SCALE_T)
    frames = torch.as_tensor(
        rng.integers(0, 2, (t_max, SCALE_C, 8, 23), dtype=np.int8), device=device)

    def run(T):
        state = init_state(SCALE_C, carry_enh=False, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, pcm, res = pipeline.run_sequence("imbe7200", frames[:T], state)
        total = pcm.sum().item()  # consume the PCM; .item() synchronizes
        dt = time.perf_counter() - t0
        assert pcm.shape == (T, SCALE_C, 160)
        assert np.isfinite(total) and bool(torch.isfinite(pcm).all())
        assert bool((res["status"] == 0).all())
        return dt

    torch.cuda.reset_peak_memory_stats(device)
    voiced.LAUNCHES = 0
    run(2)  # warm-up: device tables, allocator
    times = {T: [] for T in SCALE_T}
    for _ in range(2):
        for T in SCALE_T:
            times[T].append(run(T))
    launches = voiced.LAUNCHES
    assert launches == 2 + 2 * sum(SCALE_T), f"voiced kernel launched {launches} times"
    peak = torch.cuda.max_memory_allocated(device)

    dn = SCALE_T[1] - SCALE_T[0]
    slope = (min(times[SCALE_T[1]]) - min(times[SCALE_T[0]])) / dn
    print(f"scale C={SCALE_C}: run seconds {times!r}")
    print(f"scale C={SCALE_C}: slope({SCALE_T[0]},{SCALE_T[1]}) {slope * 1e3!r} ms/frame-step, "
          f"{SCALE_C / slope!r} frames/s, peak memory {peak / 2**30!r} GiB "
          f"[{card()}]")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mbe_tpu_torch import pipeline
    from mbe_tpu_torch.models.state import init_state
    from mbe_tpu_torch.ops.cuda import voiced

    device = torch.device("cuda", 0)
    card_line = card()
    print(card_line)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    voiced.load_library()
    print(f"build voiced_sums: {time.perf_counter() - t0!r} s")

    k = phase_kernel(voiced, device)
    phase_goldens(pipeline, init_state, voiced, device)
    launches = phase_scale(pipeline, init_state, voiced, device)

    print(json.dumps({"kernels": [{
        "name": "voiced_sums", "route": "cuda",
        "source": "mbe_tpu_torch/csrc/voiced.cu",
        "replaces": "mbe_tpu/ops/pallas/voiced.py:140",
        "launches": launches, **k}]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
