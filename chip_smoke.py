#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (mbe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each asserting (any failure ends the run with a nonzero exit):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every kernel library of the registry (ops/cuda/build.KERNELS):
     voiced_sums (mbe_tpu_torch/csrc/voiced.cu), soft_decode
     (csrc/softecc.cu), unvoiced_wola (csrc/unvoiced.cu), sources
     (csrc/sources.cu), lane_select (csrc/select.cu) and the region marks
     (csrc/marks.cu), one nvcc each, started together;
  3. voiced_sums against its plain PyTorch version on the card at
     C = 16, 1000 and 32768, an eighth of the lanes (at least 4) edge
     lanes with steps s in {1e-4, 1e-3, pi - 1e-3, 3}: max |err| /
     max |ref| < 2e-4, both timed;
  3b. soft_decode against its plain version for the three codebooks at
     R = 16, 33, 1000 and 98304 rows (random, all-255, constant-7 and
     zero reliabilities): keys equal; both timed at the three launches of
     a soft imbe7200 step at C = 32768 (C0, R = 32768 Golay, among them);
  3c. unvoiced_wola against its plain version on the card at C = 16, 1000
     and 32768 (an eighth of the lanes at w0 = 0, an eighth at L = 56):
     max |err| / max |ref| < 1e-4 on add and on the new previousUw, both
     timed;
  3d. sources, through its three dispatchers (noise.comfort_noise,
     noise.generate_noise_with_overlap, synth.render_tone) on card
     tensors, against their plain forms on the card at C = 16, 1000 and
     32768 (every output bit-equal, floats compared as int32), each
     launching once; kernel and plain timed inside CUDA graphs (as the
     main path runs them; an eager call's time is printed beside), summed
     at C = 32768 per IMBE step (comfort noise and LCG buffer) and per AMBE
     step (and the tone);
  3e. lane_select: the calls of one C = 32768 step of imbe7200 hard (1)
     and of ambe2450 soft (4), recorded from the fourth eager step of
     random frames, each bit-equal to the plain where chain on the card
     (floats as int32), both timed inside CUDA graphs per step beside the
     byte bound (each mask read once, each written leaf written once and
     its chosen source read once per lane unless a constant);
  4. the golden vectors through the port's pipeline on the card, each
     twice: e2e_{imbe7200,imbe7100,ambe2450,ambe2400}, hard and soft (C=16,
     T=40), and long_{imbe7200,imbe7100,ambe2450,ambe2400} (C=4, T=200),
     first by an eager loop over `step`, then graphed: the e2e goldens by
     `CompiledStep` replays, the long ones by `run_sequence`. Parameter
     bits, error counts and flags bit-exact, >= 60 dB PCM SNR per frame and
     lane, >= 60 dB for the int16 stream; the graphed arm bit-exact against
     the eager one (PCM, result words, parameter bits, every state leaf;
     where a float is not, integers stay exact and the PCM is >= 60 dB per
     frame against eager, printed); voiced_sums and unvoiced_wola launched
     (or replayed) once per frame, soft_decode 3 times per soft IMBE frame
     and 2 times per soft AMBE frame, sources 2 times per IMBE frame and 3
     times per AMBE frame, lane_select once per IMBE frame and 4 times per
     AMBE frame;
  5. the main paths at full width: C = 32768 channels of random frames at
     T = 8 and T = 48, all eight configurations of bench.py: imbe7200 hard
     and soft, ambe2450 hard and soft, ambe2400 hard (soft input is random
     hard bits and reliabilities 0..255), each path in two arms, and
     imbe7100 hard and soft and ambe2400 soft in the graphed arm alone.
     The two arms run in the order eager, graphed, graphed,
     eager: eager is a Python loop over `step` (SCALE_REPS_EAGER runs per
     T), graphed is `run_sequence`, which replays the compiled step
     (SCALE_REPS runs per T). ms per frame step is the slope between the
     fastest runs of the two T (it cancels the fixed per-run cost), with
     frames/s and peak memory per arm; each run's wall and process CPU
     seconds are printed. The graphed PCM, results and state equal the
     eager ones at T = 8, bit for bit, on all eight paths. A profiled
     window of each arm of the first five (utils.profiling.trace) gives
     wall ms, device events, device busy ms and idle share per step and
     the count of each kernel's symbol per step: 1 voiced_sums_kernel, 1
     unvoiced_wola_kernel, 3 or 2 soft_decode_kernel on the soft paths,
     1 (IMBE) or 4 (AMBE) lane_select_kernel.
     Random frames are mostly error frames, but the step's work does not
     depend on frame content: B2 searches every codeword, and every FSM
     branch is computed and then selected lane by lane;
  6. the public API (mbe_tpu_torch.api) on the card: the eight
     process_*_framef and process_*_soft_framef entry points over the e2e
     goldens (as phase 4), process_imbe7200x4400_frame against
     float_to_short of the framef output, the three Data paths
     (process_*_dataf, no C0/C4 counts) over the fsm_* goldens (flags
     exact, >= 60 dB per frame), the staged ecc_c0 -> demodulate ->
     ecc_data chain against decode_*_frame for 4 codecs x hard/soft at
     C = 32768 random frames (tolerance 0), and host ms per API call
     against pipeline.step's, with the host validation of a numpy frame;
  7. state and streaming: a C = 32768 imbe7200 snapshot after 4 steps
     (utils.checkpoint save, load on the card, 4 more steps) bit-exact
     against 8 uninterrupted steps, with the npz bytes and the save and
     load seconds; StreamingDecoder(codec, 32768, depth=2), whose tick is
     a captured graph, over 8 ticks of packed bytes for each of the four
     codecs, unpacked on the device (and for imbe7200 on the host too,
     through the C shim native/mbe_host.c, whose unpack is timed beside
     its numpy form), equal to direct steps, with wall ms per tick beside
     run_sequence's;
  8. sharding and device time: sharded_step and sharded_sequence on two
     shards of cuda:0 (a CompiledStep and a stream each) for imbe7200 and
     ambe2450 hard at C = 32768 against the unsharded compiled step
     (integers exact, int16 PCM within 1 LSB with fewer than 1e-3 of
     samples differing; whether the PCM is exactly equal is printed);
     utils.profiling.device_time of a bf16 4096^3 matmul, between 1.0x and
     4x its time at the 989 TFLOP/s peak, and of one graphed imbe7200 hard
     step beside phase 5's slope;
  9. multiple processes: tools/multihost_smoke_torch.py as a subprocess,
     two torch.distributed (gloo) processes of 16384 ambe2450 channels
     each on cuda:0, each checked exactly against one unsharded process
     (its launches asserted), with each worker's ms per frame step while
     both run and the aggregate frames/s. Each phase's seconds and the
     total are printed.

Every kernel launch counter is zeroed just before each path of phases
4-9 and read just after it (phase 9's in its worker processes); each
path asserts its B1, B2, B3, S (sources) and lane_select counts. A graph
replay runs no Python: the compiled step adds its graph's launches of each
kernel (the counts during its capture) to the counters on every replay,
and phase 5's profiler traces count the kernels themselves.
`bound_ms` in the kernels JSON is the least time the
card could take for the function on this run's inputs: the larger of the
bytes it must move over the memory rate and its operations of each type
over that type's peak rate (H100 SXM data sheet, dense). The operations
are those the function needs, not those of the port's kernel design; the
design's own floor is printed beside it. The sources entry's `ms`,
`plain_ms` and `bound_ms` are an AMBE step's three launches at C = 32768;
`ms_imbe_step` and its companions an IMBE step's two; likewise the
lane_select entry's, an AMBE step's four launches and an IMBE step's one.
The last lines are the kernels JSON, the card, and {"ok": true,
"device": {...}}. There is no CPU path: without a CUDA device, or without
the package beside this script, it exits nonzero.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
SOFT_R = (16, 33, 1000, 3 * SCALE_C)
PLAIN_ROWS = 16384     # row chunk of the plain soft decode ([rows, 4096] tensors)
SCALE_REPS = 5         # runs per T in phase 5; the slope takes the fastest of each
SCALE_REPS_EAGER = 3   # runs per T of phase 5's eager arm (the graphed arm keeps 5)
UNVOICED_TOL = 1e-4    # relative to max |ref|: DFT sum order
B2_PER_SOFT_STEP = {"imbe7200": 3, "imbe7100": 3, "ambe2450": 2, "ambe2400": 2}
# S launches per step: comfort noise and the LCG buffer, and the tone in AMBE
S_PER_STEP = {"imbe7200": 2, "imbe7100": 2, "ambe2450": 3, "ambe2400": 3}
# lane_select launches per step: IMBE's headroom select; AMBE's prepare,
# update, speech-path and commit selects
L_PER_STEP = {"imbe7200": 1, "imbe7100": 1, "ambe2450": 4, "ambe2400": 4}
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
FP32_OPS_S = 33.5e12   # 67 TFLOP/s FP32 = 33.5T FMA lanes/s; one FP32 instruction per lane-op
BF16_FLOP_S = 989e12   # tensor cores, bf16 in, FP32 accumulate
COSF_OPS = 30          # FP32 instructions of one precise cosf or sincosf (estimate)
EDGE_S = (1e-4, 1e-3, np.pi - 1e-3, 3.0)  # voiced step of the edge lanes (phase 3)


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
    """Random voiced_sums inputs in the ranges of tests/test_pallas.py. The
    first max(4, c // 8) lanes are edge lanes: every harmonic step of both
    banks is one of EDGE_S (by lane), and the bank and interpolated start
    phases lie within 1e-3 below 6 rad."""
    rng = np.random.default_rng(SEED)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    arrays = [u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
              u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
              u(0, 4, (7, c)), u(-0.02, 0.02, (7, c)), u(0, 6, (7, c)),
              u(0, 2, (7, c)), u(-2e-3, 2e-3, (7, c)), u(0, 1, (160,)), u(0, 1, (160,))]
    edge = min(c, max(4, c // 8))
    for i in (2, 5):
        arrays[i][:, :edge] = np.resize(np.float32(EDGE_S), edge)
    for i in (1, 4, 8):
        arrays[i][:, :edge] = u(6 - 1e-3, 6, (arrays[i].shape[0], edge))
    return [torch.as_tensor(a, device=device) for a in arrays]


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
    # at the last (full) width: six [56,C] and five [7,C] inputs, two
    # windows and a [160,C] output. The function's least FP32 work per
    # channel is the TPU kernel's (mbe_tpu/ops/pallas/voiced.py:99-119,
    # 168-189): 3 cosf per harmonic of the two 56-harmonic banks and 6 per
    # interpolated harmonic to seed the oscillators, then per sample one
    # FMA (Chebyshev step) and one add (sum) per bank harmonic, 10 ops of
    # the double rotor and amplitude per interpolated harmonic, and 3 for
    # the windows.
    nbytes = 4 * (6 * 56 * c + 5 * 7 * c + 2 * 160 + 160 * c)
    ops = c * ((3 * 2 * 56 + 6 * 7) * COSF_OPS + 160 * (2 * 2 * 56 + 10 * 7 + 3))
    # this kernel's design, per channel: sincosf of phi and s for each of
    # the 112 bank harmonics and, in each of the 10 spans, of theta(n0),
    # delta(n0) and 2q for the 7 interpolated ones (434); per bank harmonic
    # the rotor's 4 squarings (4 ops each) and per span t1 (2) and the
    # rotation to the next span (4), 76 ops; an FMA and an add per bank
    # harmonic-sample; per interpolated harmonic-sample the amplitude and
    # the sum (2) and two rotations (8); the two window FMAs per sample
    design_ops = (434 * COSF_OPS + 112 * 76 + 2 * 56 * 160 * 2 + 7 * 160 * 10
                  + 2 * 160)
    design_ms = c * design_ops / FP32_OPS_S * 1e3
    b = bound(nbytes, fp32_ops=ops)
    print(f"kernel voiced_sums C={c}: bound {b['bound_ms']!r} ms ({b['bound_by']}); "
          f"FP32 floor of this design {design_ms!r} ms")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms, **b)


def bound(nbytes, fp32_ops=0, bf16_flops=0):
    """The least time for `nbytes` moved, `fp32_ops` FP32 lane-ops on the
    CUDA cores and `bf16_flops` on the tensor cores (the two units run
    side by side, so the slower one sets it), and which of bytes or
    operations sets it."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(fp32_ops / FP32_OPS_S, bf16_flops / BF16_FLOP_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def soft_inputs(ecc, softecc, code, rows, device):
    """Random bits; reliabilities random for half the rows, 255 for an
    eighth (the largest sums), 7 for an eighth and 0 for the last quarter
    (the tie-break cases); idx_hard from the port's hard decoder, as the
    main path makes it."""
    n = softecc.CODES[code].n
    rng = np.random.default_rng(SEED + rows)
    rel = rng.integers(0, 256, (rows, n))
    rel[rows // 2:] = 255
    rel[5 * rows // 8:] = 7
    rel[3 * rows // 4:] = 0
    bits = torch.as_tensor(rng.integers(0, 2, (rows, n)), dtype=torch.int32, device=device)
    return (bits, torch.as_tensor(rel, dtype=torch.int32, device=device),
            ecc.hard_index(bits, code))


def phase_softecc(ecc, softecc, device):
    """Keys equal at every (code, rows) and at each timed launch; kernel
    and plain timed at the launches of one soft imbe7200 step at C =
    SCALE_C (and the 7100 Hamming launch, printed only)."""
    def plain(bits, rel, idx, code):
        return torch.cat([softecc.soft_decode_keys_reference(
            bits[lo:lo + PLAIN_ROWS], rel[lo:lo + PLAIN_ROWS], idx[lo:lo + PLAIN_ROWS], code)
            for lo in range(0, bits.shape[0], PLAIN_ROWS)])

    worst = 0
    for code in softecc.CODES:
        for rows in SOFT_R:
            args = soft_inputs(ecc, softecc, code, rows, device)
            key = softecc.soft_decode_keys(*args, code)
            torch.cuda.synchronize()
            err = (key.long() - plain(*args, code).long()).abs().max().item()
            print(f"kernel soft_decode {code} R={rows}: max |key - plain key| = {err}")
            assert err == 0, f"soft_decode {code} R={rows}: keys differ"
            worst = max(worst, err)

    step = [("golay", SCALE_C), ("golay", 3 * SCALE_C), ("hamstd", 3 * SCALE_C)]
    total = dict(ms=0.0, plain_ms=0.0, nbytes=0, fp32_ops=0, bf16_flops=0, design_bf16=0,
                 design_fminf=0)
    for code, rows in step + [("ham7100", 2 * SCALE_C)]:
        args = soft_inputs(ecc, softecc, code, rows, device)
        key = softecc.soft_decode_keys(*args, code)
        err = (key.long() - plain(*args, code).long()).abs().max().item()
        assert err == 0, f"soft_decode {code} R={rows}: keys differ"
        worst = max(worst, err)
        ms = cuda_ms(lambda: softecc.soft_decode_keys(*args, code), 10)
        plain_ms = cuda_ms(lambda: plain(*args, code), 2)
        spec = softecc.CODES[code]
        ncw = softecc.table(spec.codebook, device).shape[0]
        # bits and rel read, idx_hard read, keys written. The function's
        # least work per (row, codeword): the product [q | h | hsum | 1] @
        # codeword table, exact in bf16 with FP32 accumulation (operands
        # <= 255, sums < 2^18; the TPU kernel's MXU form), of n + (n -
        # data_lo) + 2 MACs, then one min of the key on the CUDA cores.
        work = dict(nbytes=rows * (8 * spec.n + 8), fp32_ops=rows * ncw,
                    bf16_flops=2 * rows * ncw * (2 * spec.n - spec.data_lo + 2))
        # this kernel's design: the product at the padded K (48 Golay, 32
        # Hamming) on the tensor cores, and one fminf per (row, codeword)
        design = dict(bf16=2 * rows * ncw * softecc.k_padded(code), fminf=rows * ncw)
        b = bound(**work)
        print(f"kernel soft_decode {code} R={rows}: max |key - plain key| = {err}, "
              f"kernel {ms!r} ms, plain {plain_ms!r} ms, "
              f"bound {b['bound_ms']!r} ms ({b['bound_by']}); this design's floor: padded-K "
              f"product {design['bf16'] / BF16_FLOP_S * 1e3!r} ms, fminf "
              f"{design['fminf'] / FP32_OPS_S * 1e3!r} ms")
        if (code, rows) in step:
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["design_bf16"] += design["bf16"]
            total["design_fminf"] += design["fminf"]
            for k in work:
                total[k] += work[k]
    b = bound(total["nbytes"], total["fp32_ops"], total["bf16_flops"])
    print(f"kernel soft_decode per soft imbe7200 step at C={SCALE_C}: kernel {total['ms']!r} ms, "
          f"plain {total['plain_ms']!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}); "
          f"this design's floor: padded-K product {total['design_bf16'] / BF16_FLOP_S * 1e3!r} "
          f"ms, fminf {total['design_fminf'] / FP32_OPS_S * 1e3!r} ms [{card()}]")
    return dict(max_abs_err=worst, ms=total["ms"], plain_ms=total["plain_ms"], **b)


def unvoiced_inputs(c, device):
    """Random unvoiced_wola inputs in the ranges of tests/test_pallas.py:
    L 9..56 with w0 from L, an eighth of the lanes at w0 = 0 (the AMBE
    erasure model) and an eighth at L = 56."""
    rng = np.random.default_rng(SEED + c)
    L = rng.integers(9, 57, c).astype(np.int32)
    L[c // 8: c // 4] = 56
    w0 = (2.0 * np.pi * 0.4875 / (L + 0.25)).astype(np.float32)
    w0[: c // 8] = 0.0
    arrays = (w0, L, rng.uniform(0, 500, (57, c)).astype(np.float32),
              rng.integers(0, 2, (57, c)).astype(np.int32),
              rng.uniform(-400, 400, (128, c)).astype(np.float32),
              rng.uniform(0, 53125, (256, c)).astype(np.float32))
    return [torch.as_tensor(a, device=device) for a in arrays]


def phase_unvoiced(unvoiced, device):
    worst_abs = 0.0
    for c in KERNEL_C:
        args = unvoiced_inputs(c, device)
        out = unvoiced.unvoiced_wola(*args)
        torch.cuda.synchronize()
        ref = unvoiced.unvoiced_wola_reference(*args)
        errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
        rels = [e / r.abs().max().item() for e, r in zip(errs, ref)]
        ms = cuda_ms(lambda: unvoiced.unvoiced_wola(*args), 20)
        plain_ms = cuda_ms(lambda: unvoiced.unvoiced_wola_reference(*args), 5)
        print(f"kernel unvoiced_wola C={c}: max_abs_err add {errs[0]!r} uw {errs[1]!r}, "
              f"rel {rels[0]!r} {rels[1]!r}; kernel {ms!r} ms, plain {plain_ms!r} ms")
        assert max(rels) < UNVOICED_TOL, f"C={c}: relative error {rels} >= {UNVOICED_TOL}"
        assert bool((out[1][:, : c // 8] == 0).all()), f"C={c}: w0 = 0 lanes not silent"
        worst_abs = max(worst_abs, *errs)
    # at the last (full) width. Bytes: per channel w0, L, Ml [57], Vl [57],
    # previousUw [128] and the noise [256] read, add [160] and the new
    # previousUw [128] written (788 words), plus the window and table
    # constants. The function's least FP32 work per channel: two 256-point
    # real FFTs at 2.5 N log2 N flops each, the window, |X|^2, the band
    # sums and scalors, the bin scaling and the WOLA, ~12k ops, each
    # counted as one FP32 lane-op.
    nbytes = 4 * (788 * c + 256 + 256 + 3 * 160)
    ops = c * (2 * 5120 + 256 + 3 * 128 + 128 + 4 * 57 + 2 * 256 + 4 * 160)
    # this kernel's design, per channel: the window (256 ops); two 128-point
    # complex FFTs of 7 radix-2 stages x 64 butterflies, ~10 ops each (a
    # complex product and two complex adds); the split and the Hermitian
    # pack, ~12 and ~14 ops per bin; band ids, ~25 ops per bin (an IEEE
    # division, floor and four ceil); |X|^2 and the band sums, 3 per bin;
    # the scalors, ~20 per band; the WOLA, 4 per sample
    design_ops = (256 + 2 * 7 * 64 * 10 + 128 * (12 + 14 + 25 + 3) + 56 * 20
                  + 160 * 4)
    design_ms = c * design_ops / FP32_OPS_S * 1e3
    b = bound(nbytes, fp32_ops=ops)
    print(f"kernel unvoiced_wola C={c}: bound {b['bound_ms']!r} ms ({b['bound_by']}); "
          f"FP32 floor of this design {design_ms!r} ms [{card()}]")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms, **b)


def sources_inputs(noise, c, device):
    """The three dispatchers' inputs at width c (as tests/test_torch_cuda.py
    makes them): Java-Random limbs from random seeds with seeds 0, 1 and
    0xFFFFFFFF and all-0xFFFF limbs in every fifth lane; LCG seeds cold (<
    0), 0, 53124, fractional and random, previous seeds < 0 on a third of
    the lanes, fractional primes; tone ids cycling 0..255 with a few out of
    range, amplitudes -1..127, phases random and near 2^32 - 1."""
    rng = np.random.default_rng(SEED + c)
    seeds = rng.integers(0, 1 << 32, c, dtype=np.uint64).astype(np.int64)
    seeds[:3] = [0, 1, 0xFFFFFFFF][:c]
    limbs = noise.java_random_init(torch.as_tensor(seeds, device=device))
    limbs[:, 4::5] = 0xFFFF
    seed = rng.integers(0, 53125, c).astype(np.float32)
    pick = rng.integers(0, 6, c)
    seed = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                     [np.float32(-1.0), np.float32(0.0), np.float32(53124.0),
                      seed + np.float32(0.5)], seed).astype(np.float32)
    prev = rng.integers(0, 53125, c).astype(np.float32)
    prev[rng.integers(0, 3, c) == 0] = -1.0
    prime = (rng.integers(0, 53125, c) + rng.uniform(0, 1, c)).astype(np.float32)
    tone = (np.arange(c) % 256).astype(np.int32)
    tone[7::97] = -3
    tone[11::89] = 300
    amp = rng.integers(-1, 128, c).astype(np.int32)
    phases = rng.integers(0, 1 << 32, (2, c), dtype=np.uint64).astype(np.int64)
    phases[:, 1::3] = (1 << 32) - 1 - rng.integers(0, 4096, (2, len(range(1, c, 3))))

    def t(*arrays):
        return [torch.as_tensor(a, device=device) for a in arrays]
    return dict(comfort_noise=[limbs.contiguous()],
                generate_noise_with_overlap=t(seed, prev, prime),
                render_tone=t(tone, amp, phases[0], phases[1]))


def same_bits(out, ref):
    """Every output equal in dtype, shape and bits (float32 as int32, so
    that the sign of a zero counts)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return len(out) == len(ref) and all(
        o.dtype == r.dtype and o.shape == r.shape and torch.equal(bits(o), bits(r))
        for o, r in zip(out, ref))


GRAPH_CALLS = 10       # calls per CUDA graph in phase 3d's timing


def graphed_ms(fn, reps=20):
    """Device ms per fn() as the main path runs it, inside a CUDA graph:
    GRAPH_CALLS calls captured into one graph, its replays timed by CUDA
    events (an eager call of a ~0.01 ms kernel measures the host's launch
    path instead)."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    return cuda_ms(graph.replay, reps) / GRAPH_CALLS


def phase_sources(noise, synth, sources, device):
    """Phase 3d: the dispatchers on card tensors (one sources launch each)
    against their plain forms on the card, bit for bit, at KERNEL_C; at
    the full width both timed inside CUDA graphs (and the eager call),
    summed per IMBE step (comfort noise, LCG buffer) and per AMBE step
    (and the tone), beside the bound."""
    dispatch = dict(comfort_noise=noise.comfort_noise,
                    generate_noise_with_overlap=noise.generate_noise_with_overlap,
                    render_tone=synth.render_tone)
    plain = dict(comfort_noise=noise.comfort_noise_reference,
                 generate_noise_with_overlap=noise.generate_noise_with_overlap_reference,
                 render_tone=synth.render_tone_reference)
    for c in KERNEL_C:
        inputs = sources_inputs(noise, c, device)
        ms, plain_ms = {}, {}
        for name, args in inputs.items():
            before = counts()["sources"]
            out = dispatch[name](*args)
            torch.cuda.synchronize()
            assert counts()["sources"] == before + 1, f"{name} C={c}: launches"
            same = same_bits(out, plain[name](*args))
            assert same, f"sources {name} C={c}: outputs differ from the plain form"
            eager_ms = cuda_ms(lambda: dispatch[name](*args), 50)
            before = counts()["sources"]
            ms[name] = graphed_ms(lambda: dispatch[name](*args))
            assert counts()["sources"] == before + GRAPH_CALLS, f"{name} C={c}: captured launches"
            plain_ms[name] = graphed_ms(lambda: plain[name](*args))
            print(f"kernel sources {name} C={c}: bit-equal to the plain form {same}; graphed: "
                  f"kernel {ms[name]!r} ms, plain {plain_ms[name]!r} ms; an eager call "
                  f"{eager_ms!r} ms")
    # at the last (full) width, from these inputs. Bytes: comfort reads the
    # limbs [3, C] int64 and two [160] int64 jump tables and writes the
    # samples [160, C] f32 and new limbs [3, C] int64; the LCG buffer reads
    # three [C] f32 and two [161] int64 tables and writes [256, C] f32 and
    # two [C] f32; the tone reads two [C] int32, two [C] int64 and four
    # [256] tables (int64, int64, bool, bool) and writes [160, C] f32 and
    # two [C] int64. Operations: a precise sinf per sample of each active
    # oscillator (one per active tone, two per dual one). The integer
    # generator steps (a handful of INT32 instructions per sample) are left
    # out: below the bytes' time at any C.
    step1, step2, _, _ = synth._tone_tables(device)
    tid = inputs["render_tone"][0].clamp(0, 255).long()
    oscillators = int((step1[tid] != 0).sum().item() + (step2[tid] != 0).sum().item())
    nbytes = dict(comfort_noise=c * (3 * 8 + 160 * 4 + 3 * 8) + 2 * 160 * 8,
                  generate_noise_with_overlap=c * (3 * 4 + 256 * 4 + 2 * 4) + 2 * 161 * 8,
                  render_tone=c * (2 * 4 + 2 * 8 + 160 * 4 + 2 * 8) + 256 * 18)
    imbe = ("comfort_noise", "generate_noise_with_overlap")
    b_imbe = bound(sum(nbytes[k] for k in imbe))
    b_ambe = bound(sum(nbytes.values()), fp32_ops=160 * oscillators * COSF_OPS)
    writes = dict(imbe=4 * c * (160 + 256), ambe=4 * c * (2 * 160 + 256))
    per_step = {}
    for step, names, b in (("imbe", imbe, b_imbe), ("ambe", tuple(ms), b_ambe)):
        per_step[step] = (sum(ms[k] for k in names), sum(plain_ms[k] for k in names))
        print(f"kernel sources per {step.upper()} step C={c}: kernel {per_step[step][0]!r} ms, "
              f"plain {per_step[step][1]!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}); "
              f"the sample writes alone {writes[step] / HBM_BYTES_S * 1e3!r} ms; "
              f"{per_step[step][0] / b['bound_ms']!r}x the bound [{card()}]")
    return dict(max_abs_err=0.0, ms=per_step["ambe"][0], plain_ms=per_step["ambe"][1],
                ms_imbe_step=per_step["imbe"][0], plain_ms_imbe_step=per_step["imbe"][1],
                bound_ms_imbe_step=b_imbe["bound_ms"], **b_ambe)


def recorded_selects(pipeline, select, device, codec, soft):
    """The lane_select calls of one eager C = SCALE_C step of `codec` (the
    fourth of random frames, so the AMBE prepare finds its lanes already in
    AMBE mode), each in the kernel's argument form."""
    from mbe_tpu_torch.models.state import init_state
    frames, rel = scale_frames(pipeline, codec, soft, device, t_max=4)
    state = init_state(SCALE_C, carry_enh=codec.startswith("ambe"), device=device)
    launch, calls = select.lane_select, []

    def record(selects):
        calls.append(selects)
        return launch(selects)

    for t in range(4):
        if t == 3:
            select.lane_select = record
        try:
            state = pipeline.step(codec, frames[t], state, None if rel is None else rel[t])[0]
        finally:
            select.lane_select = launch
    torch.cuda.synchronize()
    return calls


def select_bytes(select, selects):
    """The least bytes of one lane_select call on these inputs: each mask
    read once; each output leaf the kernel writes written once, and per lane
    its chosen source read once unless that is a constant (through earlier
    outputs' choices)."""
    args, _, outputs = select.pack(selects)
    masks = {m.data_ptr(): m.numel() for cases, _ in selects for m, _ in cases}
    total = sum(masks.values())
    reads = []  # per output and leaf, [C] bool: the lane reads a tensor
    for o, (cases, default) in enumerate(selects):
        c = cases[0][0].shape[0]
        pick = torch.full((c,), len(cases), device=cases[0][0].device)
        for q in reversed(range(len(cases))):
            pick = torch.where(cases[q][0], q, pick)
        sources = [t for _, t in cases] + [default]
        reads.append([])
        for k in range(len(default)):
            r = torch.zeros(c, dtype=torch.bool, device=pick.device)
            for q, t in enumerate(sources):
                tensor = reads[t][k] if isinstance(t, int) else isinstance(t[k], torch.Tensor)
                r = r | ((pick == q) & tensor)
            reads[o].append(r)
            if args.out[o][k]:
                row = outputs[o][k].numel() // c * outputs[o][k].element_size()
                total += row * (c + int(r.sum().item()))
    return total


def phase_lane_select(pipeline, state, select, device):
    """Phase 3e: the lane_select calls of one C = SCALE_C step of imbe7200
    hard and of ambe2450 soft (recorded_selects), each bit-equal on the
    card to the plain where chain (select_many_reference, which makes the
    constant leaves tensors first) on the same inputs; the step's launches
    and the plain chain timed inside CUDA graphs, beside the byte bound."""
    per_step = {}
    for codec, soft in (("imbe7200", False), ("ambe2450", True)):
        calls = recorded_selects(pipeline, select, device, codec, soft)
        assert len(calls) == L_PER_STEP[codec], f"{codec}: {len(calls)} lane_select calls"

        def parms(leaves):
            return leaves if isinstance(leaves, int) else state.Parms(
                **dict(zip(state.PARMS_FIELDS, leaves)))

        plain_calls = [[([(m, parms(t)) for m, t in cases], parms(d)) for cases, d in sel]
                       for sel in calls]
        for i, (sel, p) in enumerate(zip(calls, plain_calls)):
            got = [x for out in select.lane_select(sel) for x in out]
            want = [getattr(out, k) for out in state.select_many_reference(p)
                    for k in state.PARMS_FIELDS]
            assert same_bits(got, want), f"lane_select {codec} call {i}: differs from plain"
        before = counts()["lane_select"]
        ms = graphed_ms(lambda: [select.lane_select(sel) for sel in calls])
        assert counts()["lane_select"] == before + GRAPH_CALLS * len(calls), \
            f"{codec}: captured launches"
        plain_ms = graphed_ms(lambda: [state.select_many_reference(p) for p in plain_calls])
        nbytes = sum(select_bytes(select, sel) for sel in calls)
        b = bound(nbytes)
        per_step[codec] = (ms, plain_ms, b)
        print(f"kernel lane_select per {codec} step C={SCALE_C} ({len(calls)} launches, each "
              f"bit-equal to the plain form): kernel {ms!r} ms, plain {plain_ms!r} ms, bound "
              f"{b['bound_ms']!r} ms ({b['bound_by']}, {nbytes / 1e6!r} MB); "
              f"{ms / b['bound_ms']!r}x the bound [{card()}]")
    ms, plain_ms, b = per_step["ambe2450"]
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, ms_imbe_step=per_step["imbe7200"][0],
                plain_ms_imbe_step=per_step["imbe7200"][1],
                bound_ms_imbe_step=per_step["imbe7200"][2]["bound_ms"], **b)


def check_outputs(name, vec, pcm, res, dbits=None):
    """Bit-exact counts/flags (and parameter bits), per-frame and int16 SNR."""
    from mbe_tpu_torch.ops.synth import float_to_short
    got = np.stack([res[k].cpu().numpy() for k in
                    ("c0_errors", "protected_errors", "c4_errors", "total_errors")],
                   axis=-1)
    np.testing.assert_array_equal(got, vec["res"], err_msg=f"{name} error counts")
    np.testing.assert_array_equal(res["flags"].cpu().numpy(), vec["flags"],
                                  err_msg=f"{name} flags")
    if dbits is not None:
        np.testing.assert_array_equal(dbits, vec["dbits"], err_msg=f"{name} parameter bits")
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


def zero():
    """Set every kernel's launch count to 0 (just before a path)."""
    from mbe_tpu_torch.ops.cuda import build
    build.zero()


def counts():
    """Every kernel's launch count, by counter (just after a path)."""
    from mbe_tpu_torch.ops.cuda import build
    return build.counts()


def golden(pipeline, init_state, device, name, codec, soft, step=None):
    """One golden vector through `step` (pipeline.step unless given:
    step(frame, state, rel) -> (state, audio, res, dbits)), frame by frame,
    eagerly on the card. Returns (pcm [T, C, 160], results dict of [T, C],
    parameter bits [T, C, n] numpy, the final state)."""
    vec = dict(np.load(VECTORS / f"{name}.npz"))
    T, C = vec["frames"].shape[:2]
    state = init_state(C, rng_seed=vec["seeds"], device=device)
    frames = torch.as_tensor(vec["frames"], device=device)
    rel = torch.as_tensor(vec["rel"], device=device) if soft else None
    step = step or (lambda frame, st, r: pipeline.step(codec, frame, st, r))
    zero()
    pcm, res, dbits = [], [], []
    for t in range(T):
        state, audio, r, d = step(frames[t], state, None if rel is None else rel[t])
        pcm.append(audio)
        res.append(r)
        dbits.append(d.cpu().numpy())
    pcm, res, dbits = (torch.stack(pcm), {k: torch.stack([r[k] for r in res]) for k in res[0]},
                       np.stack(dbits))
    launches = counts()
    want = dict(voiced_sums=T, unvoiced_wola=T,
                soft_decode=B2_PER_SOFT_STEP[codec] * T if soft else 0,
                sources=S_PER_STEP[codec] * T, lane_select=L_PER_STEP[codec] * T)
    assert launches == want, f"{name}: kernel launches {launches} in {T} frames, want {want}"
    check_outputs(name, vec, pcm, res, dbits)
    return pcm, res, dbits, state


def state_leaves(state):
    from mbe_tpu_torch.utils.graphs import leaves
    return leaves(state)


def min_snr_db(ref, test):
    """The worst per-row SNR (dB) of test [..., n] against ref, on the
    device; silent rows as snr_db."""
    ref = ref.double().reshape(-1, ref.shape[-1])
    p_sig = (ref ** 2).mean(dim=1)
    p_err = ((ref - test.double().reshape(ref.shape)) ** 2).mean(dim=1)
    db = 10.0 * torch.log10(p_sig / p_err.clamp(min=1e-30))
    silent = p_sig < 1e-12
    db = torch.where(silent, torch.where(p_err < 1e-12, torch.inf, -torch.inf), db)
    return db.min().item()


def same_as_eager(name, got, eager):
    """Graphed outputs (pcm, res, dbits or None, state) against the eager
    loop's: (bit-exact, worst frame dB against eager). Integers (result
    words, parameter bits, integer state leaves) must be exact; where the
    float PCM or state is not, the PCM must be >= SNR_MIN_DB per frame and
    lane against the eager PCM (the stated fallback)."""
    pcm, res, dbits, state = got
    e_pcm, e_res, e_dbits, e_state = eager
    ints = all(torch.equal(res[k], e_res[k]) for k in e_res) and set(res) == set(e_res)
    ints = ints and (dbits is None or np.array_equal(dbits, e_dbits))
    pairs = list(zip(state_leaves(state), state_leaves(e_state)))
    ints = ints and all(torch.equal(a, b) for a, b in pairs if not a.is_floating_point())
    exact = (ints and torch.equal(pcm, e_pcm)
             and all(torch.equal(a, b) for a, b in pairs if a.is_floating_point()))
    worst = np.inf if exact else min_snr_db(e_pcm.float(), pcm.float())
    assert ints, f"{name}: graphed integers differ from eager"
    assert worst >= SNR_MIN_DB, f"{name}: graphed PCM {worst} dB against eager"
    return exact, worst


def golden_graphed(pipeline, init_state, device, name, codec, soft, eager):
    """The graphed arm of one golden: CompiledStep replays (e2e) or
    run_sequence (long), against the eager loop's outputs (`eager`, from
    golden) and the golden's own bar; launches per replay asserted."""
    vec = dict(np.load(VECTORS / f"{name}.npz"))
    T, C = vec["frames"].shape[:2]
    frames = torch.as_tensor(vec["frames"], device=device)
    rel = torch.as_tensor(vec["rel"], device=device) if soft else None

    def init():
        return init_state(C, rng_seed=vec["seeds"], device=device)

    sequence = name.startswith("long")
    if sequence:
        pipeline.compiled_step(codec, init(), soft)  # the capture (and its warm-up) first
        zero()
        state, pcm, res = pipeline.run_sequence(codec, frames, init(), rel)
        dbits = None
    else:
        compiled = pipeline.CompiledStep(codec, init(), soft=soft)
        zero()
        pcm, res, dbits = [], [], []
        for t in range(T):
            state, audio, r = compiled(frames[t], None if rel is None else rel[t])
            pcm.append(audio.clone())
            res.append({k: v.clone() for k, v in r.items()})
            dbits.append(compiled.dbits.cpu().numpy())
        pcm, res, dbits = (torch.stack(pcm), {k: torch.stack([r[k] for r in res]) for k in res[0]},
                           np.stack(dbits))
    launches = counts()
    want = dict(voiced_sums=T, unvoiced_wola=T,
                soft_decode=B2_PER_SOFT_STEP[codec] * T if soft else 0,
                sources=S_PER_STEP[codec] * T, lane_select=L_PER_STEP[codec] * T)
    assert launches == want, f"{name} graphed: kernel launches {launches} in {T} replays"
    exact, worst = same_as_eager(name, (pcm, res, dbits, state), eager)
    print(f"golden {name} graphed ({'run_sequence' if sequence else 'CompiledStep'}): "
          f"bit-exact against the eager loop {exact} (worst frame against eager "
          f"{float(worst)!r} dB); kernel launches {launches} in {T} replays")
    check_outputs(f"{name} graphed", vec, pcm, res, dbits)


def phase_goldens(pipeline, init_state, device):
    for codec in ("imbe7200", "imbe7100", "ambe2450", "ambe2400"):
        names = [(f"e2e_{codec}", False), (f"e2e_{codec}_soft", True), (f"long_{codec}", False)]
        for name, soft in names:
            eager = golden(pipeline, init_state, device, name, codec, soft)
            golden_graphed(pipeline, init_state, device, name, codec, soft, eager)
    pipeline.clear_compiled()


def scale_frames(pipeline, codec, soft, device, t_max=max(SCALE_T)):
    """Random [t_max, SCALE_C, rows, cols] int8 frames and, when soft,
    uint8 reliabilities, from SEED."""
    rng = np.random.default_rng(SEED)
    shape = (t_max, SCALE_C, *pipeline.FRAME_SHAPES[codec])
    frames = torch.as_tensor(rng.integers(0, 2, shape, dtype=np.int8), device=device)
    rel = (torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=device)
           if soft else None)
    return frames, rel


def eager_sequence(pipeline, codec, frames, state, rel=None):
    """The eager arm: a Python loop over pipeline.step, the PCM and
    results stacked as run_sequence returns them."""
    pcm, res = [], []
    for t in range(frames.shape[0]):
        state, audio, r, _ = pipeline.step(codec, frames[t], state,
                                           None if rel is None else rel[t])
        pcm.append(audio)
        res.append(r)
    return state, torch.stack(pcm), {k: torch.stack([r[k] for r in res]) for k in res[0]}


def phase_scale(pipeline, init_state, device, codec, soft, reps=SCALE_REPS,
                arm="graphed"):
    """One main path at C = SCALE_C, one arm: "eager" (eager_sequence) or
    "graphed" (run_sequence, which replays the compiled step; captured
    before the counts). The slope between the fastest of `reps` T = 8 and
    T = 48 runs, each ending in a readback of the PCM sum, with every
    kernel's launch count zeroed before the runs and read after them.
    Returns {launches, slope_ms, peak_gib}."""
    frames, rel = scale_frames(pipeline, codec, soft, device)
    path = f"{codec} {'soft' if soft else 'hard'} {arm}"
    ambe = codec.startswith("ambe")
    seq = pipeline.run_sequence if arm == "graphed" else (
        lambda c, f, st, r: eager_sequence(pipeline, c, f, st, r))

    def run(T):
        state = init_state(SCALE_C, carry_enh=ambe, device=device)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        state, pcm, res = seq(codec, frames[:T], state, None if rel is None else rel[:T])
        total = pcm.sum().item()  # consume the PCM; .item() synchronizes
        dt, cpu = time.perf_counter() - t0, time.process_time() - c0
        assert pcm.shape == (T, SCALE_C, 160)
        assert np.isfinite(total) and bool(torch.isfinite(pcm).all())
        assert bool((res["status"] == 0).all())
        return dt, cpu

    if arm == "graphed":
        pipeline.clear_compiled()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    capture_s = None
    if arm == "graphed":
        state = init_state(SCALE_C, carry_enh=ambe, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.compiled_step(codec, state, soft)  # the warm-up step and the capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    zero()
    run(2)  # warm-up: device tables, allocator
    times = {T: [] for T in SCALE_T}
    cpu = {T: [] for T in SCALE_T}
    for _ in range(reps):
        for T in SCALE_T:
            dt, c = run(T)
            times[T].append(dt)
            cpu[T].append(c)
    launches = counts()
    steps = 2 + reps * sum(SCALE_T)
    per_step = dict(voiced_sums=1, unvoiced_wola=1,
                    soft_decode=B2_PER_SOFT_STEP[codec] if soft else 0,
                    sources=S_PER_STEP[codec], lane_select=L_PER_STEP[codec])
    want = {k: n * steps for k, n in per_step.items()}
    assert launches == want, f"{path}: kernel launches {launches}, want {want}"
    peak = torch.cuda.max_memory_allocated(device) / 2**30

    dn = SCALE_T[1] - SCALE_T[0]
    slope = (min(times[SCALE_T[1]]) - min(times[SCALE_T[0]])) / dn
    print(f"scale {path} C={SCALE_C}: run wall seconds {times!r}, process CPU seconds {cpu!r}")
    print(f"scale {path} C={SCALE_C}: slope({SCALE_T[0]},{SCALE_T[1]}) {slope * 1e3!r} "
          f"ms/frame-step, {SCALE_C / slope!r} frames/s, peak memory {peak!r} GiB, "
          f"kernel launches {launches} over {steps} steps"
          f"{'' if capture_s is None else f', warm-up step and capture {capture_s!r} s'} "
          f"[{card()}]")
    return dict(launches=launches, slope_ms=slope * 1e3, peak_gib=peak)


KERNEL_SYMBOLS = dict(voiced_sums="voiced_sums_kernel", soft_decode="soft_decode_kernel",
                      unvoiced_wola="unvoiced_wola_kernel", comfort_noise="comfort_noise_kernel",
                      lcg_buffer="lcg_buffer_kernel", tone_render="tone_render_kernel",
                      lane_select="lane_select_kernel")
PROFILE_STEPS = 4      # steps per profiled window in phase 5


def profile_steps(run, n, logdir):
    """`run(n)` (n steps, then a synchronize) once without the profiler for
    the wall time, then under utils.profiling.trace: (wall ms per step,
    device events per step, device busy ms per step, idle share, each
    kernel's symbol count per step)."""
    from torch.autograd import DeviceType
    from mbe_tpu_torch.utils import profiling
    run(1)
    t0 = time.perf_counter()
    run(n)
    wall = (time.perf_counter() - t0) / n * 1e3
    with profiling.trace(logdir) as prof:
        run(n)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / n / 1e3
    symbols = {k: sum(sym in e.name for e in events) / n for k, sym in KERNEL_SYMBOLS.items()}
    return wall, len(events) / n, busy, 1.0 - busy / wall, symbols


def scale_path(pipeline, init_state, device, codec, soft):
    """Phase 5 for one path: the eager and graphed arms in the order E G G
    E (the eager arm at SCALE_REPS_EAGER runs per T), the graphed PCM and
    results against the eager ones at T = 8, and a profiled window of each
    arm with the kernels' symbols counted per step. Returns the last
    graphed arm's launch counts."""
    path = f"{codec} {'soft' if soft else 'hard'}"
    arms = {}
    for arm in ("eager", "graphed", "graphed", "eager"):
        arms.setdefault(arm, []).append(phase_scale(
            pipeline, init_state, device, codec, soft,
            reps=SCALE_REPS if arm == "graphed" else SCALE_REPS_EAGER, arm=arm))

    ambe = codec.startswith("ambe")
    T = min(SCALE_T)
    frames, rel = graphed_equals_eager(pipeline, init_state, device, codec, soft)

    def eager_run(n):
        st = init_state(SCALE_C, carry_enh=ambe, device=device)
        for t in range(n):
            st, *_ = pipeline.step(codec, frames[t % T], st, None if rel is None else rel[t % T])
        torch.cuda.synchronize()

    compiled = pipeline.compiled_step(codec, init_state(SCALE_C, carry_enh=ambe, device=device),
                                      soft)

    def graphed_run(n):
        for t in range(n):
            compiled(frames[t % T], None if rel is None else rel[t % T])
        torch.cuda.synchronize()

    per_step = dict(voiced_sums=1.0, unvoiced_wola=1.0,
                    soft_decode=float(B2_PER_SOFT_STEP[codec]) if soft else 0.0,
                    comfort_noise=1.0, lcg_buffer=1.0, tone_render=float(ambe),
                    lane_select=float(L_PER_STEP[codec]))
    for arm, run in (("eager", eager_run), ("graphed", graphed_run)):
        wall, n_events, busy, idle, symbols = profile_steps(
            run, PROFILE_STEPS, ROOT / "build" / "traces" / f"{codec}_{int(soft)}_{arm}")
        print(f"profile {path} {arm} C={SCALE_C}: wall {wall!r} ms/step (no profiler), "
              f"{n_events!r} device events/step, device busy {busy!r} ms/step, idle share "
              f"{idle!r}; kernel symbols per step {symbols} [{card()}]")
        assert symbols == per_step, f"{path} {arm}: kernels per step {symbols}, want {per_step}"
    summary = {arm: dict(slope_ms=[r["slope_ms"] for r in runs],
                         peak_gib=[r["peak_gib"] for r in runs]) for arm, runs in arms.items()}
    print(f"scale {path} C={SCALE_C} summary (E G G E): {summary} [{card()}]")
    return dict(launches=arms["graphed"][-1]["launches"],
                graphed_slope_ms=[r["slope_ms"] for r in arms["graphed"]])


def graphed_equals_eager(pipeline, init_state, device, codec, soft):
    """One eager T = 8 run (eager_sequence) and run_sequence over the same
    C = SCALE_C frames: PCM, result words and every state leaf bit-exact.
    Returns the frames and reliabilities."""
    path = f"{codec} {'soft' if soft else 'hard'}"
    ambe = codec.startswith("ambe")
    T = min(SCALE_T)
    frames, rel = scale_frames(pipeline, codec, soft, device, t_max=T)
    eager = eager_sequence(pipeline, codec, frames,
                           init_state(SCALE_C, carry_enh=ambe, device=device), rel)
    state, pcm, res = pipeline.run_sequence(
        codec, frames, init_state(SCALE_C, carry_enh=ambe, device=device), rel)
    exact, worst = same_as_eager(path, (pcm, res, None, state),
                                 (eager[1], eager[2], None, eager[0]))
    print(f"scale {path} C={SCALE_C}: graphed == eager at T={T}: bit-exact {exact} (worst "
          f"frame against eager {float(worst)!r} dB) [{card()}]")
    assert exact, f"{path}: graphed run_sequence is not bit-exact against the eager loop"
    return frames, rel


def scale_graphed_path(pipeline, init_state, device, codec, soft):
    """Phase 5 for imbe7100 hard and soft and ambe2400 soft: the graphed
    arm alone (phase_scale, SCALE_REPS runs per T, launches per replay
    asserted) and graphed_equals_eager."""
    out = phase_scale(pipeline, init_state, device, codec, soft)
    graphed_equals_eager(pipeline, init_state, device, codec, soft)
    pipeline.clear_compiled()
    return out

API_NAME = {"imbe7200": "imbe7200x4400", "imbe7100": "imbe7100x4400",
            "ambe2450": "ambe3600x2450", "ambe2400": "ambe3600x2400"}
DATAF = {"imbe7200": "process_imbe4400_dataf", "ambe2450": "process_ambe2450_dataf",
         "ambe2400": "process_ambe2400_dataf"}
# B2 launches of the staged chain (ecc_c0, then one per Golay or Hamming
# block of ecc_data) and of the fused frame decode, per soft frame
B2_STAGED = {"imbe7200": 7, "imbe7100": 6, "ambe2450": 2, "ambe2400": 2}
API_REPS = 10          # calls per host-time measurement in phase 6
STREAM_TICKS = 8       # ticks of the phase-7 streaming run
CKPT_STEPS = 4         # steps before and after the phase-7 snapshot


def staged_decode(api, codec, frame, rel):
    """ecc_c0 -> demodulate -> ecc_data (-> convert_imbe7100to7200) through
    the API: (parameter bits [C, nbits], c0, protected, c4 or None)."""
    name = API_NAME[codec]
    fr1, c0 = getattr(api, f"ecc_{name}_c0")(frame, rel)
    fr2 = getattr(api, f"demodulate_{name}_data")(fr1)
    out = getattr(api, f"ecc_{name}_data")(fr2, rel)
    d, prot, c4 = out if len(out) == 3 else (*out, None)
    if codec == "imbe7100":
        d = api.convert_imbe7100to7200(d)
    return d, c0, prot, c4


def host_ms(fn, reps=API_REPS):
    """(host ms per call to issue `fn`, wall ms per call once the card has
    finished), over `reps` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter()
    torch.cuda.synchronize()
    done = time.perf_counter()
    return (issued - t0) / reps * 1e3, (done - t0) / reps * 1e3


def phase_api(api, pipeline, device):
    """Phase 6: the public API on the card."""
    # the eight frame entry points over the e2e goldens
    for codec, name in API_NAME.items():
        for soft in (False, True):
            fn = getattr(api, f"process_{name}_soft_framef" if soft else f"process_{name}_framef")

            def step(frame, st, rel, fn=fn, soft=soft):
                return fn(frame, rel, st) if soft else fn(frame, st)
            golden(pipeline, api.init_mbe_parms, device,
                   f"e2e_{codec}_soft" if soft else f"e2e_{codec}", codec, soft, step=step)
    # the int16 entry point is float_to_short of the float one, frame by frame
    vec = dict(np.load(VECTORS / "e2e_imbe7200.npz"))
    state = api.init_mbe_parms(vec["frames"].shape[1], vec["seeds"], device=device)
    for frame in torch.as_tensor(vec["frames"], device=device):
        _, pcm16, _, _ = api.process_imbe7200x4400_frame(frame, state)
        state, audio, _, _ = api.process_imbe7200x4400_framef(frame, state)
        assert torch.equal(pcm16, api.float_to_short(audio)), "process_imbe7200x4400_frame"
    print("api: process_*_framef and process_*_soft_framef over the eight e2e goldens "
          "bit-exact; process_imbe7200x4400_frame == float_to_short(framef)")

    # the Data paths over the crafted parameter streams (no C0/C4 counts)
    fsm_flags = (("erasure", api.PROCESS_FLAG_ERASURE), ("tone", api.PROCESS_FLAG_TONE),
                 ("repeat", api.PROCESS_FLAG_REPEAT), ("mute", api.PROCESS_FLAG_MUTE))
    for codec, fname in DATAF.items():
        vec = dict(np.load(VECTORS / f"fsm_{codec}.npz"))
        T = vec["dbits"].shape[0]
        state = api.init_mbe_parms(1, np.uint32(vec["seed"]), device=device)
        zero()
        worst = np.inf
        for t in range(T):
            audio, state, fsm = getattr(api, fname)(vec["dbits"][t][None], state,
                                                    np.array([vec["totals"][t]], np.int32))
            flags = sum(bit for k, bit in fsm_flags if k in fsm and bool(fsm[k][0]))
            assert flags == int(vec["flags"][t]), f"fsm_{codec} t={t}: flags {flags:#x}"
            assert int(fsm["status"][0]) == 0
            worst = min(worst, snr_db(vec["pcm"][t], audio[0].cpu().numpy()))
        launches = counts()
        assert launches == dict(voiced_sums=T, soft_decode=0, unvoiced_wola=T,
                                sources=S_PER_STEP[codec] * T,
                                lane_select=L_PER_STEP[codec] * T), \
            f"{fname}: kernel launches {launches} in {T} frames"
        print(f"api {fname} over fsm_{codec}: T={T} flags exact, worst frame "
              f"{float(worst)!r} dB, kernel launches {launches}")
        assert worst >= SNR_MIN_DB, f"fsm_{codec}: worst frame {worst} dB"

    # the staged chain equals the fused frame decode at full width
    rng = np.random.default_rng(SEED)
    for codec, name in API_NAME.items():
        shape = (SCALE_C, *pipeline.FRAME_SHAPES[codec])
        frame = torch.as_tensor(rng.integers(0, 2, shape), dtype=torch.int32, device=device)
        for soft in (False, True):
            rel = (torch.as_tensor(rng.integers(0, 256, shape), dtype=torch.int32, device=device)
                   if soft else None)
            zero()
            d, c0, prot, c4 = staged_decode(api, codec, frame, rel)
            staged = counts()
            zero()
            d_ref, res = getattr(api, f"decode_{name}_frame")(frame, rel)
            fused = counts()
            assert staged["voiced_sums"] == staged["unvoiced_wola"] == fused["voiced_sums"] \
                == fused["unvoiced_wola"] == staged["sources"] == fused["sources"] \
                == staged["lane_select"] == fused["lane_select"] == 0
            staged, fused = staged["soft_decode"], fused["soft_decode"]
            same = (torch.equal(d, d_ref) and torch.equal(c0, res["c0_errors"])
                    and torch.equal(prot, res["protected_errors"])
                    and (c4 is None or torch.equal(c4, res["c4_errors"])))
            print(f"api staged {codec} {'soft' if soft else 'hard'} C={SCALE_C}: equal to "
                  f"decode_{name}_frame {same}; soft_decode launches staged {staged}, "
                  f"fused {fused}")
            assert same, f"staged {codec} soft={soft} differs from the frame decode"
            assert (staged, fused) == ((B2_STAGED[codec], B2_PER_SOFT_STEP[codec]) if soft
                                       else (0, 0))

    # host time per call at full width: the API against pipeline.step, and
    # the host validation of a numpy frame
    frame_np = rng.integers(0, 2, (SCALE_C, *pipeline.FRAME_SHAPES["imbe7200"]))
    frame_np = frame_np.astype(np.int32)
    frame = torch.as_tensor(frame_np, device=device)
    state = api.init_mbe_parms(SCALE_C, device=device)
    t_step = host_ms(lambda: pipeline.step("imbe7200", frame, state))
    t_api = host_ms(lambda: api.process_imbe7200x4400_framef(frame, state))
    t_np = host_ms(lambda: api.process_imbe7200x4400_framef(frame_np, state))
    t0 = time.perf_counter()
    for _ in range(API_REPS):
        api._check_bits(frame_np)
    t_check = (time.perf_counter() - t0) / API_REPS * 1e3
    print(f"api host ms per call imbe7200 hard C={SCALE_C} (issue, wall): pipeline.step "
          f"{t_step!r}, process_imbe7200x4400_framef(tensor) {t_api!r}, (numpy) {t_np!r}; "
          f"host validation of the numpy frame {t_check!r} ms [{card()}]")


def stream_ticks(streaming, device, codec, packed, direct, seeds, unpack):
    """StreamingDecoder(codec, SCALE_C, depth=2, unpack) over the packed
    ticks, equal to the direct steps' (int16 PCM, result dict) and with
    its launches asserted; returns each push's ms."""
    dec = streaming.StreamingDecoder(codec, SCALE_C, rng_seed=seeds, depth=2, unpack=unpack,
                                     device=device)
    torch.cuda.synchronize()
    zero()
    got, ticks = [], []
    t0 = time.perf_counter()
    for t in range(STREAM_TICKS):
        got.extend(dec.push(packed[t]))
        ticks.append(time.perf_counter())
    got.extend(dec.flush())
    wall = time.perf_counter() - t0
    launches = counts()
    # the ticks' replays and, on the card, the one eager warm-up step
    # before the decoder captures its tick at the first push
    steps = STREAM_TICKS + (device.type == "cuda")
    assert launches == dict(voiced_sums=steps, soft_decode=0, unvoiced_wola=steps,
                            sources=S_PER_STEP[codec] * steps,
                            lane_select=L_PER_STEP[codec] * steps), launches
    assert len(got) == STREAM_TICKS and len(dec._graphs) == (device.type == "cuda")
    for t, ((pcm, res), (pcm_w, res_w)) in enumerate(zip(got, direct)):
        np.testing.assert_array_equal(pcm, pcm_w, err_msg=f"streaming {codec} {unpack} t={t}")
        for k in streaming._RES_KEYS:
            np.testing.assert_array_equal(res[k], res_w[k],
                                          err_msg=f"streaming {codec} t={t} {k}")
    push_ms = np.diff([t0] + ticks) * 1e3
    print(f"streaming {codec} C={SCALE_C} depth=2 unpack={unpack} (graphed): {STREAM_TICKS} "
          f"ticks equal to direct steps; {wall / STREAM_TICKS * 1e3!r} wall ms per tick "
          f"(the first push captures), "
          f"{float(np.median(push_ms[3:]))!r} median ms per push after the first 3 (which "
          f"pin their buffers), push ms {push_ms.tolist()!r}, kernel launches {launches} "
          f"[{card()}]")
    return push_ms


def shim_vs_numpy(native, packed, n_bits, push_ms):
    """Host ms per call of the C shim's unpack_bits and of its numpy form
    on one tick's packed bytes (equal results), and the shim's share of a
    host-unpack push (median `push_ms`)."""
    got = native.unpack_bits(packed[0], n_bits)
    np.testing.assert_array_equal(got, native.unpack_bits_reference(packed[0], n_bits))
    fns = dict(shim=native.unpack_bits, numpy=native.unpack_bits_reference)
    ms = dict(shim=[], numpy=[])
    for name in ("shim", "numpy", "numpy", "shim"):
        t0 = time.perf_counter()
        for t in range(STREAM_TICKS):
            fns[name](packed[t], n_bits)
        ms[name].append((time.perf_counter() - t0) / STREAM_TICKS * 1e3)
    print(f"native unpack_bits {list(packed.shape[1:])} uint8 -> [{SCALE_C}, {n_bits}] int32 "
          f"(host ms per call, turns shim numpy numpy shim): shim {ms['shim']!r}, numpy "
          f"{ms['numpy']!r}; the shim is {min(ms['shim']) / push_ms!r} of the median "
          f"host-unpack push ({push_ms!r} ms) [{card()}]")


def phase_state(api, pipeline, checkpoint, streaming, native, device):
    """Phase 7: a checkpoint at full width, then the streaming decoder."""
    from mbe_tpu_torch.models.state import PARMS_FIELDS
    from mbe_tpu_torch.ops.synth import float_to_short

    rng = np.random.default_rng(SEED)
    seeds = np.arange(1, SCALE_C + 1, dtype=np.uint32)
    rows, cols = pipeline.FRAME_SHAPES["imbe7200"]
    frames = torch.as_tensor(rng.integers(0, 2, (2 * CKPT_STEPS, SCALE_C, rows, cols)),
                             dtype=torch.int32, device=device)

    def run(state, lo, hi):
        pcm = []
        for t in range(lo, hi):
            state, audio, _, _ = api.process_imbe7200x4400_framef(frames[t], state)
            pcm.append(audio)
        return state, pcm

    def leaves(st):
        parts = [getattr(st, p) for p in ("cur", "prev", "enh") if getattr(st, p) is not None]
        return [getattr(p, k) for p in parts for k in PARMS_FIELDS] + [st.comfort_rng,
                                                                       st.lcg_prime]

    zero()
    ref, pcm_ref = run(api.init_mbe_parms(SCALE_C, seeds, device=device), 0, 2 * CKPT_STEPS)
    mid, pcm_a = run(api.init_mbe_parms(SCALE_C, seeds, device=device), 0, CKPT_STEPS)
    path = ROOT / "build" / "chip_smoke_snapshot.npz"
    path.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, mid)
    t_save = time.perf_counter() - t0
    nbytes = path.stat().st_size
    t0 = time.perf_counter()
    loaded = checkpoint.load(path, device=device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    path.unlink()
    fin, pcm_b = run(loaded, CKPT_STEPS, 2 * CKPT_STEPS)
    launches = counts()
    steps = 4 * CKPT_STEPS
    assert launches == dict(voiced_sums=steps, soft_decode=0, unvoiced_wola=steps,
                            sources=S_PER_STEP["imbe7200"] * steps,
                            lane_select=L_PER_STEP["imbe7200"] * steps), launches
    same_pcm = all(torch.equal(a, b) for a, b in zip(pcm_ref, pcm_a + pcm_b))
    same_state = all(torch.equal(a, b) for a, b in zip(leaves(ref), leaves(fin)))
    print(f"checkpoint imbe7200 hard C={SCALE_C}: {CKPT_STEPS} steps, save, load(cuda), "
          f"{CKPT_STEPS} steps == {2 * CKPT_STEPS} uninterrupted: PCM {same_pcm}, state "
          f"{same_state}; npz {nbytes} bytes, save {t_save!r} s, load {t_load!r} s, kernel "
          f"launches {launches} [{card()}]")
    assert same_pcm and same_state, "checkpoint resume is not bit-exact"

    # the streaming decoder over packed bytes against direct steps: every
    # codec unpacked on the device, imbe7200 on the host too (the C shim)
    for codec in pipeline.CODECS:
        rows, cols = pipeline.FRAME_SHAPES[codec]
        bits = rng.integers(0, 2, (STREAM_TICKS, SCALE_C, rows * cols)).astype(np.uint8)
        packed = np.packbits(bits, axis=-1)
        frames = torch.as_tensor(bits.reshape(STREAM_TICKS, SCALE_C, rows, cols), device=device)
        state = api.init_mbe_parms(SCALE_C, seeds, device=device)
        direct = []
        for t in range(STREAM_TICKS):
            state, audio, res, _ = pipeline.step(codec, frames[t], state)
            direct.append((float_to_short(audio).cpu().numpy(),
                           {k: v.cpu().numpy() for k, v in res.items()}))
        for unpack in ("device", "host") if codec == "imbe7200" else ("device",):
            push_ms = stream_ticks(streaming, device, codec, packed, direct, seeds,
                                   unpack)
        if codec == "imbe7200":
            assert native.available(), "the host unpack did not load the C shim"
            shim_vs_numpy(native, packed, rows * cols, float(np.median(push_ms[3:])))
        pipeline.clear_compiled()
        for _ in range(2):  # run_sequence over the same frames, PCM read back (the first captures)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, pcm, res = pipeline.run_sequence(
                codec, frames, api.init_mbe_parms(SCALE_C, seeds, device=device), int16=True)
            pcm = pcm.cpu().numpy()
            wall = time.perf_counter() - t0
        np.testing.assert_array_equal(pcm, np.stack([p for p, _ in direct]))
        print(f"run_sequence {codec} C={SCALE_C} T={STREAM_TICKS} (graphed), int16 PCM read "
              f"back: {wall / STREAM_TICKS * 1e3!r} wall ms per frame step [{card()}]")
        pipeline.clear_compiled()


SHARD_T = 8            # frames of the phase-8 sharded runs
MATMUL_N = 4096        # phase 8: device_time of a bf16 [N, N] @ [N, N]


def phase_sharding(pipeline, sharding, profiling, init_state, device, hard_slope_ms):
    """Phase 8: sharded_step and sharded_sequence on two shards of cuda:0
    (a CompiledStep and a stream each) against the unsharded compiled step
    at C = SCALE_C; device_time of a bf16 matmul against the card's peak
    and of one graphed imbe7200 hard step."""
    mesh = sharding.channel_mesh(["cuda:0", "cuda:0"])
    for codec in ("imbe7200", "ambe2450"):
        ambe = codec.startswith("ambe")
        frames, _ = scale_frames(pipeline, codec, False, device, t_max=SHARD_T)
        seeds = np.arange(1, SCALE_C + 1, dtype=np.uint32)

        def init():
            return init_state(SCALE_C, rng_seed=seeds, carry_enh=ambe, device=device)

        ref_state, ref_pcm, ref_res = pipeline.run_sequence(codec, frames, init())
        steady = {"unsharded run_sequence": timed(
            lambda: pipeline.run_sequence(codec, frames, init()))}
        pipeline.clear_compiled()
        runs = {}
        zero()
        step = sharding.sharded_step(codec, mesh)
        shards = sharding.shard_state(init(), mesh)
        pcm, res = [], []
        for t in range(SHARD_T):
            shards, audio, r = step(frames[t], shards)
            pcm.append(audio)
            res.append(r)
        runs["sharded_step"] = (frozen(shards), torch.stack(pcm),
                                {k: torch.stack([r[k] for r in res]) for k in res[0]},
                                counts())

        def step_again(shards=shards):
            for t in range(SHARD_T):
                shards, *_ = step(frames[t], shards)

        steady["sharded_step"] = timed(step_again)
        zero()
        sequence = sharding.sharded_sequence(codec, mesh)
        shards, pcm, res = sequence(frames, sharding.shard_state(init(), mesh))
        runs["sharded_sequence"] = (frozen(shards), pcm, res, counts())
        steady["sharded_sequence"] = timed(lambda: sequence(frames, shards))
        for name, (shards, pcm, res, launches) in runs.items():
            # per shard a replay per frame and, on the card, the one eager
            # warm-up step before its capture
            steps = len(mesh) * (SHARD_T + (device.type == "cuda"))
            want = dict(voiced_sums=steps, soft_decode=0, unvoiced_wola=steps,
                        sources=S_PER_STEP[codec] * steps, lane_select=L_PER_STEP[codec] * steps)
            assert launches == want, f"{name} {codec}: kernel launches {launches}, want {want}"
            diff = (float_to_short_of(pcm).int() - float_to_short_of(ref_pcm).int()).abs()
            ints = all(torch.equal(res[k], ref_res[k]) for k in ref_res)
            full = [torch.cat(parts, dim=-1) for parts in zip(*shards)]
            ints = ints and all(torch.equal(a, b) for a, b in zip(full, state_leaves(ref_state))
                                if not a.is_floating_point())
            print(f"{name} {codec} hard C={SCALE_C} on {len(mesh)} shards of cuda:0: integers "
                  f"exact {ints}; PCM equal to the unsharded compiled step "
                  f"{torch.equal(pcm, ref_pcm)}; int16 samples differing "
                  f"{(diff > 0).float().mean().item()!r}, max {diff.max().item()} LSB; kernel "
                  f"launches {launches} [{card()}]")
            assert ints, f"{name} {codec}: integers differ from the unsharded step"
            assert diff.max().item() <= 1 and (diff > 0).float().mean().item() < 1e-3
        print(f"sharding {codec} hard C={SCALE_C}: wall ms per frame over {SHARD_T} frames once "
              f"captured: {steady!r} [{card()}]")
        del runs, shards, step, sequence
        torch.cuda.empty_cache()

    n = MATMUL_N
    gen = torch.Generator(device=device).manual_seed(SEED)
    a = (torch.randn((n, n), device=device, generator=gen) / n ** 0.5).to(torch.bfloat16)
    x = torch.randn((n, n), device=device, generator=gen).to(torch.bfloat16)
    sec = profiling.device_time(lambda c: a @ c, x, iters=50, short_iters=10)
    peak = 2 * n ** 3 / BF16_FLOP_S
    print(f"device_time bf16 matmul {n}x{n}x{n}: {sec * 1e3!r} ms per iteration, "
          f"{2 * n ** 3 / sec / 1e12!r} TFLOP/s, {sec / peak!r}x the {peak * 1e3!r} ms at "
          f"{BF16_FLOP_S / 1e12:.0f} TFLOP/s [{card()}]")
    assert 1.0 <= sec / peak <= 4.0, f"matmul slope {sec / peak}x its peak time"

    frames, _ = scale_frames(pipeline, "imbe7200", False, device, t_max=1)
    zero()
    sec = profiling.device_time(lambda st: pipeline.step("imbe7200", frames[0], st)[0],
                                init_state(SCALE_C, carry_enh=False, device=device),
                                iters=24, short_iters=4)
    launches = counts()
    assert launches["voiced_sums"] == launches["unvoiced_wola"] > 24
    assert launches["sources"] == S_PER_STEP["imbe7200"] * launches["voiced_sums"]
    assert launches["lane_select"] == L_PER_STEP["imbe7200"] * launches["voiced_sums"]
    print(f"device_time one graphed imbe7200 hard step C={SCALE_C}: {sec * 1e3!r} ms per "
          f"step, beside phase 5's graphed slope {hard_slope_ms!r} ms/frame-step (run_sequence: "
          f"frame copy in, replay, PCM and results copied out) [{card()}]")


def frozen(shards):
    """Copies of each shard state's leaves (a donated state changes on the
    next call)."""
    return [[x.clone() for x in state_leaves(s)] for s in shards]


def timed(fn):
    """Wall ms per frame of fn() over SHARD_T frames, ended by a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / SHARD_T * 1e3


def float_to_short_of(pcm):
    from mbe_tpu_torch.ops.synth import float_to_short
    return float_to_short(pcm)


MULTIHOST_T = 8         # frames of the phase-9 two-process job
MULTIHOST_TIMEOUT = 600  # seconds the phase-9 job may take; the golden child, then
CHILD_TIMEOUT = 270      # the two workers, may each take this long


def phase_multihost(ambe_slope_ms):
    """Phase 9: tools/multihost_smoke_torch.py as a subprocess, two
    torch.distributed processes of SCALE_C / 2 ambe2450 channels each on
    cuda:0 against one unsharded process (each worker asserts its own
    launches and exactness); any failure of it fails this run."""
    cmd = [sys.executable, str(ROOT / "tools" / "multihost_smoke_torch.py"), "--device", "cuda",
           "--codec", "ambe2450", "--channels", str(SCALE_C), "--frames", str(MULTIHOST_T),
           "--timeout", str(CHILD_TIMEOUT)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MULTIHOST_TIMEOUT,
                          cwd=ROOT)
    print(proc.stdout, end="")
    if proc.returncode != 0 or "MULTIHOST SMOKE OK" not in proc.stdout:
        print(proc.stderr, end="", file=sys.stderr)
        raise RuntimeError(f"multihost_smoke_torch exited {proc.returncode}")
    print(f"multihost ambe2450 hard C={SCALE_C} as 2 x {SCALE_C // 2} on cuda:0: beside phase "
          f"5's graphed slope {ambe_slope_ms!r} ms/frame-step in this process [{card()}]")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mbe_tpu_torch import api, native, pipeline
    from mbe_tpu_torch.models import state
    from mbe_tpu_torch.models.state import init_state
    from mbe_tpu_torch.parallel import sharding, streaming
    from mbe_tpu_torch.utils import checkpoint, profiling
    from mbe_tpu_torch.ops import ecc
    from mbe_tpu_torch.ops import noise, synth
    from mbe_tpu_torch.ops.cuda import build, select, softecc, sources, unvoiced, voiced

    device = torch.device("cuda", 0)
    card_line = card()
    print(card_line)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]!r} s", flush=True)
        return out

    def compile_kernels():
        libraries = {k.source: k for k in build.KERNELS}  # an entry point of each
        with ThreadPoolExecutor(len(libraries)) as pool:
            for fut in [pool.submit(k.load) for k in libraries.values()]:
                fut.result()
        print(f"build {' + '.join(source.name for source in libraries)}")

    def scale():
        paths = {}
        for codec, soft in (("imbe7200", False), ("imbe7200", True), ("ambe2450", False),
                            ("ambe2450", True), ("ambe2400", False)):
            paths[codec, soft] = scale_path(pipeline, init_state, device, codec, soft)
        for codec, soft in (("imbe7100", False), ("imbe7100", True), ("ambe2400", True)):
            paths[codec, soft] = scale_graphed_path(pipeline, init_state, device, codec,
                                                    soft)
        pipeline.clear_compiled()
        return paths

    phase("2 build", compile_kernels)
    k_voiced = phase("3 voiced_sums", phase_kernel, voiced, device)
    k_soft = phase("3b soft_decode", phase_softecc, ecc, softecc, device)
    k_unvoiced = phase("3c unvoiced_wola", phase_unvoiced, unvoiced, device)
    k_sources = phase("3d sources", phase_sources, noise, synth, sources, device)
    k_select = phase("3e lane_select", phase_lane_select, pipeline, state, select, device)
    phase("4 goldens", phase_goldens, pipeline, init_state, device)
    paths = phase("5 full width", scale)
    phase("6 api", phase_api, api, pipeline, device)
    phase("7 state and streaming", phase_state, api, pipeline, checkpoint, streaming, native,
          device)
    phase("8 sharding", phase_sharding, pipeline, sharding, profiling, init_state, device,
          paths["imbe7200", False]["graphed_slope_ms"])
    torch.cuda.empty_cache()
    phase("9 multihost", phase_multihost, paths["ambe2450", False]["graphed_slope_ms"])
    print(f"seconds per phase {seconds!r}; total {time.perf_counter() - t_start!r} s "
          f"[{card_line}]")

    print(json.dumps({"kernels": [
        {"name": "voiced_sums", "route": "cuda",
         "source": "mbe_tpu_torch/csrc/voiced.cu",
         "replaces": "mbe_tpu/ops/pallas/voiced.py:140",
         "launches": paths["imbe7200", False]["launches"]["voiced_sums"], **k_voiced},
        {"name": "soft_decode", "route": "cuda",
         "source": "mbe_tpu_torch/csrc/softecc.cu",
         "replaces": "mbe_tpu/ops/pallas/softecc.py:128",
         "launches": paths["imbe7200", True]["launches"]["soft_decode"], **k_soft},
        {"name": "unvoiced_wola", "route": "cuda",
         "source": "mbe_tpu_torch/csrc/unvoiced.cu",
         "replaces": "mbe_tpu/ops/pallas/unvoiced.py:174",
         "launches": paths["ambe2450", False]["launches"]["unvoiced_wola"], **k_unvoiced},
        {"name": "sources", "route": "cuda",
         "source": "mbe_tpu_torch/csrc/sources.cu",
         "replaces": "no TPU kernel: plain PyTorch, mbe_tpu_torch/ops/noise.py:comfort_noise_"
                     "reference, generate_noise_with_overlap_reference, ops/synth.py:"
                     "render_tone_reference",
         "launches": paths["ambe2450", False]["launches"]["sources"], **k_sources},
        {"name": "lane_select", "route": "cuda",
         "source": "mbe_tpu_torch/csrc/select.cu",
         "replaces": "no TPU kernel: plain PyTorch, mbe_tpu_torch/models/state.py:"
                     "select_many_reference",
         "launches": paths["ambe2450", False]["launches"]["lane_select"], **k_select}]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
