"""The noise and tone sources (ops/cuda/sources.py, csrc/sources.cu) on the
CPU: the one dispatch in ops/noise.py and ops/synth.py (plain forms for
CPU tensors, the kernel for CUDA tensors, any other device raises), the
kernel entry points' checks, and a numpy emulation of the kernel's
arithmetic (span seeds from the jump tables, sequential steps, the 96-row
overlap seam, the state written by the last span) held against the plain
forms bit for bit. The kernel itself runs in tests/test_torch_cuda.py on
the card.
"""

import numpy as np
import pytest
import torch

from mbe_tpu_torch.ops import noise, synth
from mbe_tpu_torch.ops.cuda import build, sources

ENTRIES = ["comfort_noise", "generate_noise_with_overlap", "render_tone"]
DISPATCH = {"comfort_noise": noise.comfort_noise,
            "generate_noise_with_overlap": noise.generate_noise_with_overlap,
            "render_tone": synth.render_tone}
PLAIN = {"comfort_noise": noise.comfort_noise_reference,
         "generate_noise_with_overlap": noise.generate_noise_with_overlap_reference,
         "render_tone": synth.render_tone_reference}
MASK48 = np.uint64((1 << 48) - 1)
F32 = np.float32


def _inputs(entry, c, seed=0):
    """Inputs of each entry point at width c: random limbs with all-0xFFFF
    lanes; LCG seeds with cold (< 0), 0, 53124 and fractional lanes and
    negative previous seeds; every tone id with out-of-range ones,
    amplitudes -1..127 and phases near 2^32 - 1."""
    rng = np.random.default_rng(seed + c)
    if entry == "comfort_noise":
        limbs = rng.integers(0, 1 << 16, (3, c))
        limbs[:, 1::4] = 0xFFFF
        return [torch.as_tensor(limbs, dtype=torch.int64)]
    if entry == "generate_noise_with_overlap":
        seed_ = rng.integers(0, 53125, c).astype(F32)
        seed_[0::5] = -1.0
        seed_[1::5] = 0.0
        seed_[2::5] = 53124.0
        seed_[3::5] += F32(0.5)
        prev = rng.integers(0, 53125, c).astype(F32)
        prev[0::3] = -1.0
        prime = (rng.integers(0, 53125, c) + rng.uniform(0, 1, c)).astype(F32)
        return [torch.as_tensor(a) for a in (seed_, prev, prime)]
    tone = (np.arange(c) % 256).astype(np.int32)
    tone[5::37] = -2
    tone[6::41] = 999
    amp = rng.integers(-1, 128, c).astype(np.int32)
    phases = rng.integers(0, 1 << 32, (2, c), dtype=np.uint64).astype(np.int64)
    phases[:, 1::3] = (1 << 32) - 1 - rng.integers(0, 4096, (2, len(range(1, c, 3))))
    return [torch.as_tensor(a) for a in (tone, amp, phases[0], phases[1])]


def _kernel_call(entry, args):
    """The kernel entry point behind `entry` and its arguments as the
    dispatcher passes them (tables and gains on the inputs' device)."""
    device = args[0].device
    if entry == "comfort_noise":
        return sources.comfort_noise, [args[0], 160, *noise._java_jumps(device),
                                       noise.COMFORT_GAIN]
    if entry == "generate_noise_with_overlap":
        return sources.lcg_buffer, [*args, *noise._lcg_tables(device)]
    return sources.render_tone, [*args, synth._tone_tables(device), synth.SOFT_CLIP,
                                 synth.TONE_RAD, synth.HALF_PI]


def _assert_same_bits(out, ref):
    """Equal dtypes, shapes and bits: float32 outputs compared as int32, so
    that the sign of a zero counts."""
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        if o.dtype == torch.float32:
            o, r = o.view(torch.int32), r.view(torch.int32)
        assert torch.equal(o, r)


@pytest.mark.parametrize("c", [1, 33, 300])
@pytest.mark.parametrize("entry", ENTRIES)
def test_dispatch_on_cpu_returns_the_plain_outputs(entry, c):
    """For CPU tensors each dispatcher runs its plain form: the same bits,
    and no launch counted."""
    args = _inputs(entry, c)
    before = build.LAUNCHES["sources"].n
    out = DISPATCH[entry](*args)
    assert build.LAUNCHES["sources"].n == before
    _assert_same_bits(out, PLAIN[entry](*args))


@pytest.mark.parametrize("entry", ENTRIES)
def test_dispatch_raises_on_other_devices(entry):
    args = [a.to("meta") for a in _inputs(entry, 8)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        DISPATCH[entry](*args)


@pytest.mark.parametrize("entry,index,dtype", [("comfort_noise", 0, torch.int32),
                                               ("generate_noise_with_overlap", 2, torch.float64),
                                               ("render_tone", 1, torch.int64),
                                               ("render_tone", 3, torch.int32)])
def test_wrapper_raises_on_a_wrong_dtype(entry, index, dtype):
    args = _inputs(entry, 8)
    args[index] = args[index].to(dtype)
    fn, kargs = _kernel_call(entry, args)
    with pytest.raises(ValueError, match="must be"):
        fn(*kargs)


@pytest.mark.parametrize("entry", ENTRIES)
def test_wrapper_raises_on_a_wrong_shape_or_layout(entry):
    args = _inputs(entry, 8)
    wrong = list(args)
    wrong[-1] = wrong[-1][:2] if entry == "comfort_noise" else wrong[-1][:4]
    fn, kargs = _kernel_call(entry, wrong)
    with pytest.raises(ValueError, match="must be"):
        fn(*kargs)
    strided = [a.repeat_interleave(2, dim=-1)[..., ::2] for a in args]
    fn, kargs = _kernel_call(entry, strided)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*kargs)


def test_comfort_noise_rows_out_of_range_raise():
    fn, args = _kernel_call("comfort_noise", _inputs("comfort_noise", 8))
    args[1] = 0
    with pytest.raises(ValueError, match="n must"):
        fn(*args)


# --- numpy emulations of the kernel's arithmetic ------------------------------

def _emulate_comfort(limbs, span, rows=160):
    l64 = limbs.numpy().astype(np.uint64)
    s = (l64[0] + (l64[1] << np.uint64(16)) + (l64[2] << np.uint64(32))) & MASK48
    ja, jb = (t.numpy().astype(np.uint64) for t in noise._java_jumps("cpu"))
    out = np.empty((rows, s.shape[0]), F32)
    for n0 in range(0, rows, span):
        x = (ja[n0] * s + jb[n0]) & MASK48
        for n in range(n0, min(n0 + span, rows)):
            if n > n0:
                x = (x * np.uint64(noise._JMULT) + np.uint64(noise._JADD)) & MASK48
            val = (x >> np.uint64(24)).astype(F32)
            out[n] = ((val / F32(16777216.0)) * F32(2.0) - F32(1.0)) * F32(noise.COMFORT_GAIN)
    new = np.stack([x & np.uint64(0xFFFF), (x >> np.uint64(16)) & np.uint64(0xFFFF),
                    x >> np.uint64(32)]).astype(np.int64)
    return torch.as_tensor(out), torch.as_tensor(new)


def _emulate_lcg(seed, prev, prime, span):
    a, b = (t.numpy()[:, 0].astype(np.uint64) for t in noise._lcg_tables("cpu"))
    sd, ps = seed.numpy(), prev.numpy()
    cold = sd < 0
    cur = np.mod(sd.astype(np.int32), noise.LCG_M).astype(np.uint64)
    prv = (np.where(ps < 0, F32(0), ps).astype(np.int64) % noise.LCG_M).astype(np.uint64)
    m = np.uint64(noise.LCG_M)
    buf = np.empty((256, sd.shape[0]), F32)
    x = np.zeros_like(cur)
    for r0 in range(0, 256, span):
        for r in range(r0, min(r0 + span, 256)):
            if r in (r0, 96):
                k, base = (64 + r, prv) if r < 96 else (r - 96, cur)
                x = (a[k] * base + b[k]) % m
            else:
                x = (np.uint64(171) * x + np.uint64(11213)) % m
            buf[r] = np.where((r < 96) & (ps < 0), F32(0), x.astype(F32))
    buf[:, cold] = 0.0
    nxt = ((np.uint64(171) * x + np.uint64(11213)) % m).astype(F32)
    new_seed = np.where(cold, prime.numpy(), nxt)
    new_prev = np.where(cold, F32(-1.0), sd)
    return tuple(torch.as_tensor(v) for v in (buf, new_seed, new_prev))


def _emulate_tone(tone_id, amplitude_id, swn, tone_phase, span):
    """The kernel's phases, angles and state; the sine is torch's over the
    [160, C] angles, as the plain form takes it; the gain by the float
    reciprocal of 127."""
    step1_t, step2_t, active_t, dual_t = (t.numpy() for t in synth._tone_tables("cpu"))
    tid = np.clip(tone_id.numpy(), 0, 255)
    s1, s2 = step1_t[tid].astype(np.uint32), step2_t[tid].astype(np.uint32)
    active, dual = active_t[tid], dual_t[tid]
    gain = ((np.maximum(amplitude_id.numpy(), 0).astype(F32) * F32(sources.INV_127))
            * F32(synth.SOFT_CLIP))
    g1 = np.where(active, np.where(dual, F32(0.5) * gain, gain), F32(0))
    g2 = np.where(dual, F32(0.5) * gain, F32(0))
    p1, p2 = swn.numpy().astype(np.uint32), tone_phase.numpy().astype(np.uint32)
    ang = np.empty((2, 160, tid.shape[0]), F32)
    for n0 in range(0, 160, span):
        for n in range(n0, min(n0 + span, 160)):
            for i, (p, s) in enumerate(((p1, s1), (p2, s2))):
                ph = p + s * np.uint32(n + 1)
                ang[i, n] = ph.astype(F32) * F32(synth.TONE_RAD) - F32(synth.HALF_PI)
    sines = torch.sin(torch.as_tensor(ang))
    samples = torch.as_tensor(g1) * sines[0] + torch.as_tensor(g2) * sines[1]
    m32 = np.int64(0xFFFFFFFF)
    new_swn = np.where(active, (swn.numpy() + step1_t[tid] * 160) & m32, swn.numpy())
    new_tp = np.where(dual, (tone_phase.numpy() + step2_t[tid] * 160) & m32, tone_phase.numpy())
    return samples, torch.as_tensor(new_swn), torch.as_tensor(new_tp)


@pytest.mark.parametrize("span", [1, 7, 16, 32, 160, 256])
@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_arithmetic_matches_the_plain_forms(entry, span):
    """The kernel's arithmetic, emulated in numpy for each split of the rows
    into spans (ragged ones included), against the plain forms at
    tolerance 0. For the tone the amplitudes are those whose gain is the
    same by division and by the reciprocal (the plain form divides on the
    CPU; PyTorch's CUDA division by a number, which the kernel repeats,
    multiplies by the reciprocal)."""
    args = _inputs(entry, 300, seed=span)
    if entry == "render_tone":
        same = [a for a in range(-1, 128)
                if F32(max(a, 0)) / F32(127.0) == F32(max(a, 0)) * F32(sources.INV_127)]
        assert len(same) > 100
        args[1] = torch.as_tensor(np.resize(np.int32(same), 300))
    emulate = {"comfort_noise": _emulate_comfort, "generate_noise_with_overlap": _emulate_lcg,
               "render_tone": _emulate_tone}[entry]
    _assert_same_bits(emulate(*args, span), PLAIN[entry](*args))
