"""The port on the card: the voiced, soft-decode, unvoiced, sources and
lane-select kernels against their plain versions, the golden vectors through the
pipeline and the public API with the kernels in the loop, checkpoints, the streaming
decoder (and the C host shim), the compiled step (a CUDA graph replay,
bit-exact against the eager step), channel sharding, the two-process job,
the profiling helpers and the tracing (region marks in traced replays and
ticks, host span counts).

Marked `cuda`; without a card every test skips. This file imports
neither jax nor mbe_tpu (nor the jax-importing conftest's helpers), so
on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mbe_tpu_torch import pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import ecc, noise, synth
from mbe_tpu_torch.ops.cuda import build, softecc, sources, unvoiced, voiced

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parent / "vectors"
RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors")
B123 = ("voiced_sums", "unvoiced_wola", "soft_decode")  # the kernels' launch counters


def _counts(*counters):
    """The registry's launch counts of `counters` (ops/cuda/build.LAUNCHES)."""
    return np.array([build.LAUNCHES[k].n for k in counters])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)


def _snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    p_sig = np.mean(ref ** 2)
    p_err = np.mean((ref - np.asarray(test, np.float64)) ** 2)
    if p_sig < 1e-12:
        return np.inf if p_err < 1e-12 else -np.inf
    return 10.0 * np.log10(p_sig / max(p_err, 1e-30))


def _kernel_inputs(c, device, edge=False):
    """voiced_sums inputs in the ranges of tests/test_pallas.py; with
    `edge`, the first 16 lanes step every harmonic of both banks by one of
    1e-4, 1e-3, pi - 1e-3 and 3 (by lane), from start phases within 1e-3
    below 6 rad."""
    rng = np.random.default_rng(7)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    arrays = [u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
              u(0, 5, (56, c)), u(0, 6, (56, c)), u(0, 3, (56, c)),
              u(0, 4, (7, c)), u(-0.02, 0.02, (7, c)), u(0, 6, (7, c)),
              u(0, 2, (7, c)), u(-2e-3, 2e-3, (7, c)), u(0, 1, (160,)), u(0, 1, (160,))]
    if edge:
        for i in (2, 5):
            arrays[i][:, :16] = np.resize(np.float32([1e-4, 1e-3, np.pi - 1e-3, 3.0]), 16)
        for i in (1, 4, 8):
            arrays[i][:, :16] = u(6 - 1e-3, 6, (arrays[i].shape[0], 16))
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("c,edge", [(16, False), (1000, False), (32768, False), (1000, True)],
                         ids=["16", "1000", "32768", "edge1000"])
def test_voiced_kernel_matches_plain(cuda_device, c, edge):
    """Kernel vs plain version at ragged and full widths, and with small-s
    edge lanes: max |err| / max |ref| < 2e-4 (the recurrence drift bound
    of the TPU kernel), over all lanes and over the edge lanes alone."""
    args = _kernel_inputs(c, cuda_device, edge)
    before = build.LAUNCHES["voiced_sums"].n
    out = voiced.voiced_sums(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["voiced_sums"].n == before + 1
    ref = voiced.voiced_sums_reference(*args)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 2e-4
    if edge:
        err = (out[:, :16] - ref[:, :16]).abs().max() / ref[:, :16].abs().max()
        assert err.item() < 2e-4


@pytest.mark.cuda
def test_voiced_kernel_rejects_bad_inputs(cuda_device):
    args = _kernel_inputs(64, cuda_device)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        voiced.voiced_sums(*bad)
    bad = list(args)
    bad[1] = torch.empty((64, 56), device=cuda_device).T
    with pytest.raises(ValueError, match="contiguous"):
        voiced.voiced_sums(*bad)


def _golden_on_card(device, name, codec, soft, step=None):
    """One golden vector through `step` (pipeline.step unless given:
    step(frame, state, rel)) on the card: parameter bits, error counts and
    flags bit-exact, >= 60 dB per frame and lane and for the int16 stream;
    B1 and B3 launched once per frame, B2 3 times per soft IMBE frame and
    2 times per soft AMBE frame."""
    vec = dict(np.load(VECTORS / f"{name}.npz"))
    T, C = vec["frames"].shape[:2]
    state = st.init_state(C, rng_seed=vec["seeds"], device=device)
    frames = torch.as_tensor(vec["frames"], device=device)
    rel = torch.as_tensor(vec["rel"], device=device) if soft else None
    before = _counts(*B123)
    pcm16 = []
    for t in range(T):
        r = None if rel is None else rel[t]
        state, audio, res, d = (step(frames[t], state, r) if step
                                else pipeline.step(codec, frames[t], state, r))
        np.testing.assert_array_equal(d.cpu().numpy(), vec["dbits"][t])
        got = np.stack([res[k].cpu().numpy() for k in RES_KEYS], axis=1)
        np.testing.assert_array_equal(got, vec["res"][t])
        np.testing.assert_array_equal(res["flags"].cpu().numpy(), vec["flags"][t])
        for i in range(C):
            assert _snr_db(vec["pcm"][t, i], audio[i].cpu().numpy()) >= 60.0, (t, i)
        pcm16.append(synth.float_to_short(audio).cpu().numpy())
    b2 = (3 if codec.startswith("imbe") else 2) * T if soft else 0
    assert tuple(_counts(*B123) - before) == (T, T, b2)
    assert _snr_db(vec["pcm16"], np.stack(pcm16)) >= 60.0


@pytest.mark.cuda
def test_e2e_imbe7200_on_card(cuda_device):
    """e2e_imbe7200 through the port on the card (_golden_on_card)."""
    _golden_on_card(cuda_device, "e2e_imbe7200", "imbe7200", False)


def _soft_inputs(code, rows, device):
    """Random bits; reliabilities random in the first half of the rows,
    255 in the fifth eighth (the largest sums), 7 in the sixth and 0 in
    the last quarter (the tie-break cases); the hard decode's codeword
    index."""
    n = softecc.CODES[code].n
    rng = np.random.default_rng(rows)
    rel = rng.integers(0, 256, (rows, n))
    rel[rows // 2:] = 255
    rel[5 * rows // 8:] = 7
    rel[3 * rows // 4:] = 0
    bits = torch.as_tensor(rng.integers(0, 2, (rows, n)), dtype=torch.int32, device=device)
    return (bits, torch.as_tensor(rel, dtype=torch.int32, device=device),
            ecc.hard_index(bits, code))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 33, 1000, 32768, 98304])
@pytest.mark.parametrize("code", ["golay", "hamstd", "ham7100"])
def test_softecc_kernel_matches_plain(cuda_device, code, rows):
    """B2 against its plain version at ragged (not a multiple of the
    64-row tile) and full row counts, tie cases and all-255 rows included:
    the int32 keys are equal (tolerance 0), which also shows that the
    tensor cores accumulate the bf16 products exactly."""
    bits, rel, idx = _soft_inputs(code, rows, cuda_device)
    before = build.LAUNCHES["soft_decode"].n
    key = softecc.soft_decode_keys(bits, rel, idx, code)
    torch.cuda.synchronize()
    assert build.LAUNCHES["soft_decode"].n == before + 1
    for lo in range(0, rows, 16384):  # the plain version holds [rows, ncw] tensors
        ref = softecc.soft_decode_keys_reference(bits[lo:lo + 16384], rel[lo:lo + 16384],
                                                 idx[lo:lo + 16384], code)
        assert torch.equal(key[lo:lo + 16384], ref), lo


@pytest.mark.cuda
def test_softecc_kernel_rejects_bad_inputs(cuda_device):
    bits, rel, idx = _soft_inputs("golay", 64, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        softecc.soft_decode_keys(bits.long(), rel, idx, "golay")
    with pytest.raises(ValueError, match="contiguous"):
        softecc.soft_decode_keys(bits, torch.empty((23, 64), dtype=torch.int32,
                                                   device=cuda_device).T, idx, "golay")
    with pytest.raises(ValueError, match="int32"):
        softecc.soft_decode_keys(bits[:, :15], rel[:, :15], idx, "golay")


@pytest.mark.cuda
def test_e2e_imbe7200_soft_on_card(cuda_device):
    """e2e_imbe7200_soft through the port on the card, B2 launched three
    times per frame (_golden_on_card)."""
    _golden_on_card(cuda_device, "e2e_imbe7200_soft", "imbe7200", True)


@pytest.mark.cuda
@pytest.mark.parametrize("name,codec,soft", [("e2e_ambe2450", "ambe2450", False),
                                             ("e2e_ambe2400_soft", "ambe2400", True)])
def test_e2e_ambe_on_card(cuda_device, name, codec, soft):
    """AMBE goldens through the port on the card, B2 launched twice per
    soft frame (_golden_on_card)."""
    _golden_on_card(cuda_device, name, codec, soft)


def _unvoiced_inputs(c, device):
    """unvoiced_wola inputs in the ranges of tests/test_pallas.py, an
    eighth of the lanes at w0 = 0 (the AMBE erasure model) and an eighth
    at L = 56."""
    rng = np.random.default_rng(c)
    L = rng.integers(9, 57, c).astype(np.int32)
    L[c // 8: c // 4] = 56
    w0 = (2.0 * np.pi * 0.4875 / (L + 0.25)).astype(np.float32)
    w0[: c // 8] = 0.0
    arrays = (w0, L, rng.uniform(0, 500, (57, c)).astype(np.float32),
              rng.integers(0, 2, (57, c)).astype(np.int32),
              rng.uniform(-400, 400, (128, c)).astype(np.float32),
              rng.uniform(0, 53125, (256, c)).astype(np.float32))
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 33, 1000, 32768])
def test_unvoiced_kernel_matches_plain(cuda_device, c):
    """B3 against its plain version at ragged (33: one lane in a partial
    block) and full widths: max |err| /
    max |ref| < 1e-4 on add and on the new previousUw; the w0 = 0 lanes
    give a zero new previousUw."""
    args = _unvoiced_inputs(c, cuda_device)
    before = build.LAUNCHES["unvoiced_wola"].n
    out = unvoiced.unvoiced_wola(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["unvoiced_wola"].n == before + 1
    ref = unvoiced.unvoiced_wola_reference(*args)
    for o, r in zip(out, ref):
        assert ((o - r).abs().max() / r.abs().max()).item() < 1e-4
    assert (out[1][:, : c // 8] == 0).all()


@pytest.mark.cuda
def test_unvoiced_kernel_rejects_bad_inputs(cuda_device):
    args = _unvoiced_inputs(64, cuda_device)
    for i, bad, match in ((0, args[0].double(), "float32"), (3, args[3][:56], "int32"),
                          (4, args[4].cpu(), "cuda"),
                          (5, torch.empty((64, 256), device=cuda_device).T, "contiguous")):
        with pytest.raises(ValueError, match=match):
            unvoiced.unvoiced_wola(*args[:i], bad, *args[i + 1:])


# --- the noise and tone sources (csrc/sources.cu) -----------------------------

SOURCES_C = [1, 33, 4097, 32768]


def _comfort_limbs(c, device):
    """Java-Random limbs [3, C] from seeds 0, 1, 0xFFFFFFFF and random ones
    (java_random_init), random 48-bit states in every fifth lane from the
    fourth, and limbs whose 16-bit parts are all 0xFFFF in every fifth
    lane from the fifth."""
    rng = np.random.default_rng(c + 5)
    seeds = rng.integers(0, 1 << 32, c, dtype=np.uint64).astype(np.int64)
    seeds[:3] = [0, 1, 0xFFFFFFFF][:c]
    limbs = noise.java_random_init(torch.as_tensor(seeds, device=device))
    limbs[:, 3::5] = torch.as_tensor(rng.integers(0, 1 << 16, (3, len(range(3, c, 5)))),
                                     device=device)
    limbs[:, 4::5] = 0xFFFF
    return limbs.contiguous()


def _lcg_inputs(c, device):
    """noise_seed, noise_prev_seed, prime [C] f32: seeds < 0 (cold), 0,
    53124, random states and fractional values; previous seeds < 0 on a
    third of the lanes; fractional primes."""
    rng = np.random.default_rng(c + 7)
    seed = rng.integers(0, 53125, c).astype(np.float32)
    pick = rng.integers(0, 6, c)
    seed = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                     [np.float32(-1.0), np.float32(0.0), np.float32(53124.0),
                      seed + np.float32(0.5)], seed).astype(np.float32)
    seed[:2] = [-0.25, 53124.0][:c]
    prev = rng.integers(0, 53125, c).astype(np.float32)
    prev[rng.integers(0, 3, c) == 0] = -1.0
    prime = (rng.integers(0, 53125, c) + rng.uniform(0, 1, c)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (seed, prev, prime)]


def _tone_inputs(c, device):
    """tone_id and amplitude_id [C] int32 and swn, tonePhase [C] int64: the
    tone ids cycle through 0..255 (active, dual and inactive ids) with a
    few out of range; amplitudes -1, 0, 127 and random; phases random, 0
    and near 2^32 - 1."""
    rng = np.random.default_rng(c + 11)
    tone = (np.arange(c) % 256).astype(np.int32)
    tone[7::97] = -3
    tone[11::89] = 300
    amp = rng.integers(-1, 128, c).astype(np.int32)
    amp[:3] = [-1, 0, 127][:c]
    phases = rng.integers(0, 1 << 32, (2, c), dtype=np.uint64).astype(np.int64)
    phases[:, 1::3] = (1 << 32) - 1 - rng.integers(0, 4096, (2, len(range(1, c, 3))))
    phases[:, 2::7] = 0
    return [torch.as_tensor(a, device=device) for a in (tone, amp, phases[0], phases[1])]


def _assert_equal_outputs(out, ref):
    """Equal dtypes, shapes and bits: float32 outputs are compared as
    int32, so that the sign of a zero counts."""
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.dtype == r.dtype and o.shape == r.shape, i
        if o.dtype == torch.float32:
            o, r = o.view(torch.int32), r.view(torch.int32)
        assert torch.equal(o, r), (i, (o != r).nonzero()[:8].tolist())


SOURCES_DISPATCH = {"comfort_noise": noise.comfort_noise,
                    "generate_noise_with_overlap": noise.generate_noise_with_overlap,
                    "render_tone": synth.render_tone}
SOURCES_PLAIN = {"comfort_noise": noise.comfort_noise_reference,
                 "generate_noise_with_overlap": noise.generate_noise_with_overlap_reference,
                 "render_tone": synth.render_tone_reference}


@pytest.mark.cuda
@pytest.mark.parametrize("c", SOURCES_C)
@pytest.mark.parametrize("entry", ["comfort_noise", "generate_noise_with_overlap",
                                   "render_tone"])
def test_sources_kernel_matches_plain(cuda_device, entry, c):
    """Each dispatcher (noise.comfort_noise, noise.generate_noise_with_overlap,
    synth.render_tone) on card tensors, which launches the sources kernel
    once, against its plain form on the card: every output bit-equal."""
    args = {"comfort_noise": lambda: [_comfort_limbs(c, cuda_device)],
            "generate_noise_with_overlap": lambda: _lcg_inputs(c, cuda_device),
            "render_tone": lambda: _tone_inputs(c, cuda_device)}[entry]()
    before = build.LAUNCHES["sources"].n
    out = SOURCES_DISPATCH[entry](*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sources"].n == before + 1
    _assert_equal_outputs(out, SOURCES_PLAIN[entry](*args))


@pytest.mark.cuda
def test_sources_kernel_chains_frames(cuda_device):
    """Twenty frames of each generator chained through its own state (the
    kernel's state in, the kernel's state out) equal the plain chain."""
    limbs = _comfort_limbs(4097, cuda_device)
    seed, prev, prime = _lcg_inputs(4097, cuda_device)
    tone, amp, swn, tp = _tone_inputs(4097, cuda_device)
    k_state = (limbs, seed, prev, swn, tp)
    p_state = k_state
    for _ in range(20):
        outs = []
        for comfort, lcg, tone_fn, st_ in (
                (*SOURCES_DISPATCH.values(), k_state), (*SOURCES_PLAIN.values(), p_state)):
            cn, li = comfort(st_[0])
            buf, s2, p2 = lcg(st_[1], st_[2], prime)
            ts, w2, t2 = tone_fn(tone, amp, st_[3], st_[4])
            outs.append(((cn, buf, ts), (li, s2, p2, w2, t2)))
        _assert_equal_outputs(outs[0][0], outs[1][0])
        _assert_equal_outputs(outs[0][1], outs[1][1])
        k_state, p_state = outs[0][1], outs[1][1]


@pytest.mark.cuda
def test_sources_kernel_rejects_bad_inputs(cuda_device):
    limbs = _comfort_limbs(64, cuda_device)
    lcg = _lcg_inputs(64, cuda_device)
    tone = _tone_inputs(64, cuda_device)
    jumps = (*noise._java_jumps(cuda_device), noise.COMFORT_GAIN)
    lcg_tables = noise._lcg_tables(cuda_device)
    tone_tables = (synth._tone_tables(cuda_device), synth.SOFT_CLIP, synth.TONE_RAD,
                   synth.HALF_PI)
    with pytest.raises(ValueError, match="int64"):
        sources.comfort_noise(limbs.int(), 160, *jumps)
    with pytest.raises(ValueError, match="contiguous"):
        sources.comfort_noise(torch.empty((64, 3), dtype=torch.int64, device=cuda_device).T,
                              160, *jumps)
    with pytest.raises(ValueError, match="n must"):
        sources.comfort_noise(limbs, 161, *jumps)
    with pytest.raises(ValueError, match="float32"):
        sources.lcg_buffer(lcg[0], lcg[1].double(), lcg[2], *lcg_tables)
    with pytest.raises(ValueError, match="cuda"):
        sources.lcg_buffer(lcg[0], lcg[1], lcg[2].cpu(), *lcg_tables)
    with pytest.raises(ValueError, match="int32"):
        sources.render_tone(tone[0].long(), *tone[1:], *tone_tables)
    with pytest.raises(ValueError, match=r"\(64,\)"):
        sources.render_tone(tone[0], tone[1], tone[2][:32], tone[3], *tone_tables)


def _random_frames(codec, T, C, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2, (T, C, *pipeline.FRAME_SHAPES[codec])),
                           dtype=torch.int32, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec,tones,nodes", [("imbe7200", True, 2), ("ambe2450", True, 3),
                                               ("ambe2450", False, 2)],
                         ids=["imbe7200", "ambe2450", "ambe2450-notones"])
def test_sources_nodes_per_captured_step(cuda_device, codec, tones, nodes):
    """A CompiledStep's graph holds the sources kernel's launches: comfort
    noise and the LCG buffer in every codec, the tone where tones are
    rendered; each replay advances its count by as many."""
    from mbe_tpu_torch.utils.config import DecoderConfig
    C = 1000
    config = DecoderConfig(codec=codec, tones_enabled=tones)
    compiled = pipeline.CompiledStep(
        codec, st.init_state(C, rng_seed=np.arange(1, C + 1, dtype=np.uint32),
                             carry_enh=codec.startswith("ambe"), device=cuda_device),
        config=config)
    assert dict(compiled._graph.launches)[build.LAUNCHES["sources"]] == nodes
    frames = _random_frames(codec, 3, C, 3)
    before = build.LAUNCHES["sources"].n
    for t in range(3):
        compiled(frames[t])
    assert build.LAUNCHES["sources"].n - before == 3 * nodes


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["imbe7200", "ambe2450"])
def test_sources_run_sequence_equals_plain_forms(cuda_device, codec, monkeypatch):
    """50 frames of random bits (erasures, repeats, mutes, tones) through
    run_sequence on the card: the state, result words and PCM equal those
    of the same code with the plain forms forced in place of the kernel."""
    C, T = 4097, 50
    frames = _random_frames(codec, T, C, 50)
    seeds = np.random.default_rng(51).integers(0, 1 << 32, C, dtype=np.uint64).astype(np.uint32)

    def run():
        """run_sequence from a fresh capture; the kernel's launches in it."""
        pipeline.clear_compiled()

        def init():
            return st.init_state(C, rng_seed=seeds, carry_enh=codec.startswith("ambe"),
                                 device=cuda_device)

        pipeline.compiled_step(codec, init())  # capture before counting
        before = build.LAUNCHES["sources"].n
        return pipeline.run_sequence(codec, frames, init()), build.LAUNCHES["sources"].n - before

    kernel, launches = run()
    assert launches == T * (3 if codec == "ambe2450" else 2)
    with monkeypatch.context() as m:
        m.setattr(noise, "comfort_noise", noise.comfort_noise_reference)
        m.setattr(noise, "generate_noise_with_overlap",
                  noise.generate_noise_with_overlap_reference)
        m.setattr(synth, "render_tone", synth.render_tone_reference)
        plain, launches = run()
        assert launches == 0
    pipeline.clear_compiled()
    assert torch.equal(kernel[1], plain[1])
    for k in plain[2]:
        assert torch.equal(kernel[2][k], plain[2][k]), k
    assert all(torch.equal(a, b) for a, b in zip(_leaves(kernel[0]), _leaves(plain[0])))


# --- the FSM's lane selects (kernel lane_select) ---------------------------------

SELECT_C = (1, 33, 4097, 32768)
SELECT_SITES = ("imbe_headroom", "ambe_prepare", "ambe2450_update", "ambe_speech",
                "ambe2450_commit", "ambe2400_update", "ambe2400_commit")
SELECT_PER_STEP = {"imbe7200": 1, "imbe7100": 1, "ambe2450": 4, "ambe2400": 4}


def _card_parms(rng, c, device):
    """Parms of random leaves on the card: floats with -0.0 and a NaN
    payload in some lanes, int32 over their range, uint32-valued int64."""
    out = {}
    for k in st.PARMS_FIELDS:
        rows, dtype = st.LEAF_LAYOUT[k]
        shape = (*rows, c)
        if dtype == torch.float32:
            a = rng.normal(size=shape).astype(np.float32)
            a.reshape(-1)[::7] = -0.0
            a.view(np.int32).reshape(-1)[3::11] = 0x7FC0_1234
        elif dtype == torch.int32:
            a = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
        else:
            a = rng.integers(0, 2**32, shape, dtype=np.int64)
        out[k] = torch.as_tensor(a, device=device)
    return st.Parms(**out)


def _card_masks(rng, c, n, device, pattern):
    """n [C] bool masks: random (pattern 0), all true (1), all false (2), or
    overlapping runs (3: mask i set on lanes i*c/4 .. i*c/4 + c/2)."""
    lanes = np.arange(c)
    make = {0: lambda i: rng.random(c) < 0.3, 1: lambda i: np.ones(c, bool),
            2: lambda i: np.zeros(c, bool),
            3: lambda i: (lanes >= i * c // 4) & (lanes < i * c // 4 + max(c // 2, 1))}[pattern]
    return [torch.as_tensor(make(i), device=device) for i in range(n)]


def _select_site(site, rng, c, device, pattern):
    """The `selects` of one FSM call site, as the codecs build them, over
    random parameters and masks."""
    cur, prev, enh, other = (_card_parms(rng, c, device) for _ in range(4))
    m = _card_masks(rng, c, 3, device, pattern)
    defaults = st.default_leaves(ambe=True)
    cur_z = dataclasses.replace(cur, repeatCount=torch.zeros_like(cur.repeatCount))
    cur_rep = dataclasses.replace(prev, repeatCount=prev.repeatCount + 1)
    cur_tone = dataclasses.replace(cur, swn=other.swn, tonePhase=other.tonePhase)
    return {
        "imbe_headroom": lambda: [([(m[0], st.imbe_headroom_reset(cur)), (m[1], cur_rep)], cur)],
        "ambe_prepare": lambda: [([(m[0], defaults)], p) for p in (cur, prev, enh)],
        "ambe2450_update": lambda: [([(m[0], st.erasure_parms(cur_z, prev)), (m[1], cur_z),
                                      (m[2], cur_rep)], cur_z)],
        "ambe_speech": lambda: [([(m[0], enh)], dataclasses.replace(cur, Ml=other.Ml))],
        "ambe2450_commit": lambda: [
            ([(m[0], other), (m[1], cur_tone), (m[2], defaults)], cur),
            ([(m[0], enh), (m[1] & ~m[0], 0), (m[2], defaults)], prev),
            ([(m[0] | m[1], other), (m[1], 0), (m[2], defaults)], enh)],
        "ambe2400_update": lambda: [([(m[0], cur_z), (m[1], cur), (m[2], cur_rep)], cur_z)],
        "ambe2400_commit": lambda: [
            ([(m[0], other), (m[1], cur_tone), (m[2], defaults)], cur),
            ([(m[0], enh), (m[1], 0), (m[2], defaults)], prev),
            ([(m[0], other), (m[2], defaults)], enh)],
    }[site]()


def _assert_same_parms(got, want):
    """Equal dtypes, shapes and bits, leaf for leaf (floats as int32)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_equal_outputs([getattr(g, k) for k in st.PARMS_FIELDS],
                              [getattr(w, k) for k in st.PARMS_FIELDS])


@pytest.mark.cuda
@pytest.mark.parametrize("c", SELECT_C)
@pytest.mark.parametrize("site", SELECT_SITES)
def test_lane_select_matches_plain(cuda_device, site, c):
    """Each FSM select site on its own: st.select_many on card tensors,
    which launches lane_select once, equals the plain where chain on the
    card bit for bit, with random, all-true, all-false and overlapping
    masks."""
    rng = np.random.default_rng(c + SELECT_SITES.index(site))
    for pattern in range(4):
        selects = _select_site(site, rng, c, cuda_device, pattern)
        before = build.LAUNCHES["lane_select"].n
        got = st.select_many(selects)
        torch.cuda.synchronize()
        assert build.LAUNCHES["lane_select"].n == before + 1
        _assert_same_parms(got, st.select_many_reference(selects))


@pytest.mark.cuda
def test_lane_select_chained_commit(cuda_device):
    """The commit trio in one launch: on erasure lanes (no earlier case set)
    prev and enh take the new cur, whichever source the new cur chose there
    (the synthesized, tone, default or kept parameters)."""
    c = 4096
    rng = np.random.default_rng(5)
    cur, prev, enh, synth_out = (_card_parms(rng, c, cuda_device) for _ in range(4))
    lane = torch.arange(c, device=cuda_device)
    voice_ok, tone_play, reinit = lane % 5 == 0, lane % 5 == 1, lane % 5 == 2
    is_era = lane % 3 != 0
    cur_tone = dataclasses.replace(cur, swn=synth_out.swn, tonePhase=synth_out.tonePhase)
    defaults = st.default_leaves(ambe=True)
    selects = [([(voice_ok, synth_out), (tone_play, cur_tone), (reinit, defaults)], cur),
               ([(voice_ok, prev), (is_era, 0), (reinit, defaults)], prev),
               ([(voice_ok | tone_play, synth_out), (is_era, 0), (reinit, defaults)], enh)]
    got = st.select_many(selects)
    _assert_same_parms(got, st.select_many_reference(selects))
    era = is_era & ~voice_ok

    def bits(x):  # float leaves hold NaN payloads: compare their bits
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    for k in st.PARMS_FIELDS:
        new = bits(getattr(got[0], k))
        assert torch.equal(bits(getattr(got[1], k))[..., era], new[..., era]), k
        assert torch.equal(bits(getattr(got[2], k))[..., era & ~tone_play],
                           new[..., era & ~tone_play]), k


def _select_frames(codec, soft, T, C, device):
    """[T, C] frames (and reliabilities) mixing real content and noise: a
    golden's channels with a time offset per channel (tones, silence,
    erasures, repeats), random bits on every third channel (erasures,
    repeats, mutes, headroom resets)."""
    name = f"e2e_{codec}_soft" if soft else f"long_{codec}"
    vec = dict(np.load(VECTORS / f"{name}.npz"))
    n, width = vec["frames"].shape[:2]
    ch = np.arange(C)
    t = (np.arange(T)[:, None] + 7 * ch[None, :]) % n
    frames = vec["frames"][t, ch % width].astype(np.int32)
    rng = np.random.default_rng(C)
    noise = ch % 3 == 2
    frames[:, noise] = rng.integers(0, 2, frames[:, noise].shape)
    rel = None
    if soft:
        rel = vec["rel"][t, ch % width]
        rel[:, noise] = rng.integers(0, 256, rel[:, noise].shape)
        rel = torch.as_tensor(rel, device=device)
    return torch.as_tensor(frames, device=device), rel


SELECT_RUNS = [("imbe7200", False), ("imbe7200", True), ("imbe7100", False), ("ambe2450", True),
               ("ambe2400", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("codec,soft", SELECT_RUNS,
                         ids=[f"{c}-{'soft' if s else 'hard'}" for c, s in SELECT_RUNS])
def test_lane_select_run_sequence_equals_plain(cuda_device, codec, soft, monkeypatch):
    """20 chained frames through run_sequence (golden content with tones,
    silence and erasures, and noise) on 2052 channels: state, result words
    and PCM equal those of the same run with the plain selects forced in
    place of the kernel, and the kernel ran 1 (IMBE) or 4 (AMBE) times a
    step."""
    from mbe_tpu_torch.models import ambe
    C, T = 2052, 20
    frames, rel = _select_frames(codec, soft, T, C, cuda_device)
    seeds = np.arange(1, C + 1, dtype=np.uint32)

    def run():
        pipeline.clear_compiled()

        def init():
            return st.init_state(C, rng_seed=seeds, carry_enh=codec.startswith("ambe"),
                                 device=cuda_device)

        pipeline.compiled_step(codec, init(), soft)  # capture before counting
        before = build.LAUNCHES["lane_select"].n
        out = pipeline.run_sequence(codec, frames, init(), rel)
        return out, build.LAUNCHES["lane_select"].n - before

    kernel, launches = run()
    assert launches == T * SELECT_PER_STEP[codec]
    with monkeypatch.context() as m:
        m.setattr(st, "select_many", st.select_many_reference)
        m.setattr(ambe, "select_many", st.select_many_reference)
        plain, launches = run()
        assert launches == 0
    pipeline.clear_compiled()
    assert torch.equal(kernel[1].view(torch.int32), plain[1].view(torch.int32))
    for k in plain[2]:
        assert torch.equal(kernel[2][k], plain[2][k]), k
    for a, b in zip(_leaves(kernel[0]), _leaves(plain[0])):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", pipeline.CODECS)
def test_lane_select_nodes_per_captured_step(cuda_device, codec):
    """A CompiledStep's graph holds lane_select's launches, 1 per IMBE step
    and 4 per AMBE one; each replay advances its count by as many."""
    C = 1000
    compiled = pipeline.CompiledStep(
        codec, st.init_state(C, carry_enh=codec.startswith("ambe"), device=cuda_device))
    nodes = dict(compiled._graph.launches)[build.LAUNCHES["lane_select"]]
    assert nodes == SELECT_PER_STEP[codec]
    frames = _random_frames(codec, 3, C, 3)
    before = build.LAUNCHES["lane_select"].n
    for t in range(3):
        compiled(frames[t])
    assert build.LAUNCHES["lane_select"].n - before == 3 * nodes


@pytest.mark.cuda
def test_lane_select_rejects_bad_inputs(cuda_device):
    """Wrong dtype, device, shape, a non-contiguous leaf or mask: ValueError
    before any launch."""
    rng = np.random.default_rng(6)
    a, b = _card_parms(rng, 64, cuda_device), _card_parms(rng, 64, cuda_device)
    m = torch.as_tensor(rng.random(64) < 0.5, device=cuda_device)

    def call(mask=m, **kw):
        return st.select_many([([(mask, dataclasses.replace(b, **kw))], a)])

    before = build.LAUNCHES["lane_select"].n
    with pytest.raises(ValueError, match="float64"):
        call(w0=a.w0.double())
    with pytest.raises(ValueError, match="cpu"):
        call(L=a.L.cpu())
    with pytest.raises(ValueError, match="shape"):
        call(Ml=a.Ml[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        call(Ml=torch.empty((64, 57), device=cuda_device).T)
    with pytest.raises(ValueError, match="mask"):
        call(mask=m.int())
    with pytest.raises(ValueError, match="contiguous"):
        call(mask=torch.zeros((64, 2), dtype=torch.bool, device=cuda_device)[:, 0])
    assert build.LAUNCHES["lane_select"].n == before


# --- the public API, checkpoints and streaming on the card ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_api_framef_on_card(cuda_device, soft):
    """process_imbe7200x4400_[soft_]framef over the golden on the card:
    the same outputs and kernel launches as pipeline.step."""
    from mbe_tpu_torch import api

    def step(frame, state, rel):
        if soft:
            return api.process_imbe7200x4400_soft_framef(frame, rel, state)
        return api.process_imbe7200x4400_framef(frame, state)

    _golden_on_card(cuda_device, "e2e_imbe7200_soft" if soft else "e2e_imbe7200", "imbe7200",
                    soft, step=step)


@pytest.mark.cuda
def test_api_dataf_on_card(cuda_device):
    """process_imbe4400_dataf over fsm_imbe7200 on the card (no C0/C4
    counts): flags exact, >= 60 dB per frame, B1 and B3 once per frame."""
    from mbe_tpu_torch import api
    vec = dict(np.load(VECTORS / "fsm_imbe7200.npz"))
    T = vec["dbits"].shape[0]
    state = api.init_mbe_parms(1, np.uint32(vec["seed"]), device=cuda_device)
    before = _counts("voiced_sums", "unvoiced_wola")
    for t in range(T):
        audio, state, fsm = api.process_imbe4400_dataf(
            torch.as_tensor(vec["dbits"][t][None], device=cuda_device), state,
            torch.tensor([int(vec["totals"][t])], device=cuda_device))
        flags = (api.PROCESS_FLAG_REPEAT * int(fsm["repeat"][0])
                 | api.PROCESS_FLAG_MUTE * int(fsm["mute"][0]))
        assert flags == int(vec["flags"][t]), t
        assert _snr_db(vec["pcm"][t], audio[0].cpu().numpy()) >= 60.0, t
    assert tuple(_counts("voiced_sums", "unvoiced_wola") - before) == (T, T)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", pipeline.CODECS)
def test_api_staged_equals_frame_decode_on_card(cuda_device, codec):
    """ecc_c0 -> demodulate -> ecc_data equals decode_*_frame on the card,
    hard and soft (B2 for every soft block), tolerance 0."""
    from mbe_tpu_torch import api
    name = {"imbe7200": "imbe7200x4400", "imbe7100": "imbe7100x4400",
            "ambe2450": "ambe3600x2450", "ambe2400": "ambe3600x2400"}[codec]
    rng = np.random.default_rng(17)
    shape = (1000, *pipeline.FRAME_SHAPES[codec])
    frame = torch.as_tensor(rng.integers(0, 2, shape), dtype=torch.int32, device=cuda_device)
    for rel in (None, torch.as_tensor(rng.integers(0, 256, shape), dtype=torch.int32,
                                      device=cuda_device)):
        fr1, c0 = getattr(api, f"ecc_{name}_c0")(frame, rel)
        out = getattr(api, f"ecc_{name}_data")(getattr(api, f"demodulate_{name}_data")(fr1), rel)
        d = api.convert_imbe7100to7200(out[0]) if codec == "imbe7100" else out[0]
        d_ref, res = getattr(api, f"decode_{name}_frame")(frame, rel)
        assert torch.equal(d, d_ref) and torch.equal(c0, res["c0_errors"])
        assert torch.equal(out[1], res["protected_errors"])
        if len(out) == 3:
            assert torch.equal(out[2], res["c4_errors"])


@pytest.mark.cuda
def test_checkpoint_resume_on_card(cuda_device, tmp_path):
    """3 steps, save, load on the card, 3 steps == 6 uninterrupted steps,
    PCM and state bit for bit."""
    from mbe_tpu_torch import api
    from mbe_tpu_torch.utils import checkpoint
    vec = dict(np.load(VECTORS / "e2e_imbe7200.npz"))
    frames = torch.as_tensor(vec["frames"][:6], device=cuda_device)

    def run(state, lo, hi):
        pcm = []
        for t in range(lo, hi):
            state, audio, _, _ = api.process_imbe7200x4400_framef(frames[t], state)
            pcm.append(audio)
        return state, pcm

    c = frames.shape[1]
    ref, pcm_ref = run(api.init_mbe_parms(c, vec["seeds"], device=cuda_device), 0, 6)
    mid, pcm_a = run(api.init_mbe_parms(c, vec["seeds"], device=cuda_device), 0, 3)
    checkpoint.save(tmp_path / "s.npz", mid)
    loaded = checkpoint.load(tmp_path / "s.npz", device=cuda_device)
    assert loaded.cur.Ml.is_cuda
    fin, pcm_b = run(loaded, 3, 6)
    assert all(torch.equal(a, b) for a, b in zip(pcm_ref, pcm_a + pcm_b))
    ref_np, fin_np = st.state_to_numpy(ref), st.state_to_numpy(fin)
    for part in ("cur", "prev", "enh"):
        for k in st.PARMS_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(fin_np, part), k),
                                          getattr(getattr(ref_np, part), k), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("unpack", ["device", "host"])
def test_streaming_on_card(cuda_device, unpack):
    """StreamingDecoder on the card (a captured tick per input kind: unpack,
    step, bundle; pinned buffers, async copies, one event per tick) equals
    direct steps, tolerance 0, at depths 1 and 3."""
    from mbe_tpu_torch.parallel.streaming import StreamingDecoder
    C, T = 300, 7
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (T, C, 96)).astype(np.uint8)
    seeds = np.arange(1, C + 1, dtype=np.uint32)
    state = st.init_state(C, rng_seed=seeds, device=cuda_device)
    want = []
    for t in range(T):
        state, audio, res, _ = pipeline.step(
            "ambe2450", torch.as_tensor(bits[t].reshape(C, 4, 24), device=cuda_device), state)
        want.append((synth.float_to_short(audio).cpu().numpy(), res["total_errors"].cpu().numpy()))
    for depth in (1, 3):
        dec = StreamingDecoder("ambe2450", C, rng_seed=seeds, depth=depth, unpack=unpack)
        got = []
        for t in range(T):
            got.extend(dec.push(np.packbits(bits[t], axis=1)))
        got.extend(dec.flush())
        assert len(got) == T and len(dec._graphs) == 1
        for (pcm, res), (pcm_w, te_w) in zip(got, want):
            np.testing.assert_array_equal(pcm, pcm_w)
            np.testing.assert_array_equal(res["total_errors"], te_w)


@pytest.mark.cuda
def test_streaming_ambe2400_on_card(cuda_device):
    """StreamingDecoder("ambe2400") at a ragged C = 33 on the card equals
    direct steps (int16 PCM and every result word), tolerance 0."""
    from mbe_tpu_torch.parallel.streaming import StreamingDecoder, _RES_KEYS
    C, T = 33, 6
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, (T, C, 96)).astype(np.uint8)
    seeds = np.arange(1, C + 1, dtype=np.uint32)
    state = st.init_state(C, rng_seed=seeds, device=cuda_device)
    want = []
    for t in range(T):
        state, audio, res, _ = pipeline.step(
            "ambe2400", torch.as_tensor(bits[t].reshape(C, 4, 24), device=cuda_device), state)
        want.append((synth.float_to_short(audio).cpu().numpy(),
                     {k: v.cpu().numpy() for k, v in res.items()}))
    dec = StreamingDecoder("ambe2400", C, rng_seed=seeds, depth=2)
    got = []
    for t in range(T):
        got.extend(dec.push(np.packbits(bits[t], axis=1)))
    got.extend(dec.flush())
    assert len(got) == T and len(dec._graphs) == 1
    for (pcm, res), (pcm_w, res_w) in zip(got, want):
        np.testing.assert_array_equal(pcm, pcm_w)
        for k in _RES_KEYS:
            np.testing.assert_array_equal(res[k], res_w[k], err_msg=k)


@pytest.mark.cuda
def test_native_shim_on_card_machine(cuda_device):
    """The C shim builds with the GPU host's C compiler and equals its
    numpy forms (unpack at C = 32768 x imbe7200's 23 bytes)."""
    from mbe_tpu_torch import native
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (32768, 23)).astype(np.uint8)
    np.testing.assert_array_equal(native.unpack_bits(packed, 184),
                                  native.unpack_bits_reference(packed, 184))
    assert native.available()
    bits = rng.integers(0, 2, (100, 49)).astype(np.int32)
    np.testing.assert_array_equal(native.pack_bits(bits), native.pack_bits_reference(bits))
    pcm = rng.integers(-32768, 32768, (64, 160)).astype(np.int16)
    np.testing.assert_array_equal(native.interleave_pcm(pcm), native.interleave_pcm_reference(pcm))
    idx = np.arange(-2, 15, dtype=np.int32)
    np.testing.assert_array_equal(native.scatter_bits(bits[:, :12], idx, idx.size),
                                  native.scatter_bits_reference(bits[:, :12], idx, idx.size))


@pytest.mark.cuda
def test_two_process_job_on_card(cuda_device):
    """tools/multihost_smoke_torch.py on cuda:0: two gloo processes of 32
    channels each (the tiled e2e_ambe2450 golden, C = 64) against one
    unsharded process, result words, state leaves and PCM exact."""
    import subprocess
    import sys
    tool = Path(__file__).resolve().parent.parent / "tools" / "multihost_smoke_torch.py"
    proc = subprocess.run([sys.executable, str(tool), "--device", "cuda", "--timeout", "240"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST SMOKE OK" in proc.stdout
    for rank in (0, 1):
        assert f"worker {rank}: channels [{32 * rank}, {32 * rank + 32}) of 64" in proc.stdout
    assert proc.stdout.count("PCM and") == 2 and "float state leaves exact" in proc.stdout


# --- the compiled step, sharding and profiling on the card ---------------------

GOLDENS = ([(f"e2e_{c}{'_soft' if soft else ''}", c, soft) for c in pipeline.CODECS
            for soft in (False, True)] + [(f"long_{c}", c, False) for c in pipeline.CODECS])


def _leaves(state):
    from mbe_tpu_torch.utils import graphs
    return graphs.leaves(state)


@pytest.mark.cuda
@pytest.mark.parametrize("name,codec,soft", GOLDENS, ids=[g[0] for g in GOLDENS])
def test_graph_replay_bit_exact_on_card(cuda_device, name, codec, soft):
    """The twelve goldens: CompiledStep replays (e2e) or run_sequence (long)
    equal the eager pipeline.step loop on the card at tolerance 0 (PCM,
    result words, parameter bits, every state leaf); each replay advances
    the kernel counters by 1 (B1), 1 (B3) and 3 or 2 (B2, soft)."""
    vec = dict(np.load(VECTORS / f"{name}.npz"))
    T, C = vec["frames"].shape[:2]
    frames = torch.as_tensor(vec["frames"], device=cuda_device)
    rel = torch.as_tensor(vec["rel"], device=cuda_device) if soft else None

    def init():
        return st.init_state(C, rng_seed=vec["seeds"], carry_enh=codec.startswith("ambe"),
                             device=cuda_device)

    state, eager = init(), []
    for t in range(T):
        state, audio, res, d = pipeline.step(codec, frames[t], state,
                                             None if rel is None else rel[t])
        eager.append((audio, res, d))
    per_step = (1, 1, (3 if codec.startswith("imbe") else 2) if soft else 0)
    if name.startswith("long"):
        pipeline.compiled_step(codec, init())  # capture before counting
        before = _counts(*B123)
        out, pcm, results = pipeline.run_sequence(codec, frames, init())
        assert torch.equal(pcm, torch.stack([e[0] for e in eager]))
        for k in results:
            assert torch.equal(results[k], torch.stack([e[1][k] for e in eager])), k
    else:
        compiled = pipeline.CompiledStep(codec, init(), soft=soft)
        before = _counts(*B123)
        for t in range(T):
            out, audio, res = compiled(frames[t], None if rel is None else rel[t])
            assert tuple(_counts(*B123) - before) == tuple((t + 1) * n for n in per_step)
            assert torch.equal(audio, eager[t][0]) and torch.equal(compiled.dbits, eager[t][2])
            assert all(torch.equal(res[k], eager[t][1][k]) for k in res), t
    assert tuple(_counts(*B123) - before) == tuple(T * n for n in per_step)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(out), _leaves(state)))


@pytest.mark.cuda
def test_sharded_step_two_shards_on_card(cuda_device):
    """sharded_step and sharded_sequence on ["cuda:0", "cuda:0"] (two
    CompiledSteps, a stream each) against the unsharded compiled step:
    integers exact; int16 PCM within 1 LSB with fewer than 1e-3 of samples
    differing (tests/test_sharding.py's rule)."""
    from mbe_tpu_torch.parallel import sharding
    C, T = 1000, 6
    rng = np.random.default_rng(11)
    frames = torch.as_tensor(rng.integers(0, 2, (T, C, 4, 24)), dtype=torch.int32,
                             device=cuda_device)
    seeds = np.arange(1, C + 1, dtype=np.uint32)
    _, ref_pcm, ref_res = pipeline.run_sequence(
        "ambe2450", frames, st.init_state(C, rng_seed=seeds, device=cuda_device))
    mesh = sharding.channel_mesh(["cuda:0", "cuda:0"])
    step = sharding.sharded_step("ambe2450", mesh)
    shards = sharding.shard_state(st.init_state(C, rng_seed=seeds, device=cuda_device), mesh)
    pcm, res = [], []
    for t in range(T):
        shards, audio, r = step(frames[t], shards)
        pcm.append(audio.clone())
        res.append({k: v.clone() for k, v in r.items()})
    seq_shards = sharding.shard_state(st.init_state(C, rng_seed=seeds, device=cuda_device), mesh)
    _, seq_pcm, seq_res = sharding.sharded_sequence("ambe2450", mesh)(frames, seq_shards)
    for got, got_res in ((torch.stack(pcm), {k: torch.stack([r[k] for r in res]) for k in res[0]}),
                         (seq_pcm, seq_res)):
        diff = (synth.float_to_short(got).int() - synth.float_to_short(ref_pcm).int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean().item() < 1e-3
        for k in ref_res:
            assert torch.equal(got_res[k], ref_res[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_sharded_list_form_two_shards_on_card(cuda_device, soft):
    """sharded_sequence's list form on ["cuda:0", "cuda:0"], int16, imbe7200
    (e2e_imbe7200_soft tiled to 1000 channels, 12 frames, two calls), each
    shard's frames on the card: each shard's PCM, result words and state
    equal run_sequence of its own channels bit for bit; the tensor form
    equals the list form gathered; against run_sequence over all channels
    the words are exact and the PCM within 1 LSB on fewer than 1e-3 of
    samples (the rule above); the rounds counter advances by 12 a call."""
    from mbe_tpu_torch.parallel import sharding
    from mbe_tpu_torch.utils import profiling
    C, T, k = 1000, 12, 2
    v = np.load(VECTORS / "e2e_imbe7200_soft.npz")
    reps = -(-C // v["frames"].shape[1])
    frames = torch.as_tensor(np.tile(v["frames"][:T], (1, reps, 1, 1))[:, :C], device=cuda_device)
    rel = (torch.as_tensor(np.tile(v["rel"][:T], (1, reps, 1, 1))[:, :C], device=cuda_device)
           if soft else None)
    seeds = np.tile(v["seeds"], reps)[:C]
    mesh = sharding.channel_mesh(["cuda:0", "cuda:0"])
    init = st.init_state(C, rng_seed=seeds, carry_enh=False, device=cuda_device)
    shards, tensor_shards, alone = (sharding.shard_state(init, mesh) for _ in range(3))
    split = [p.contiguous() for p in torch.tensor_split(frames, k, dim=1)]
    rel_split = [None] * k if rel is None else [p.contiguous()
                                                for p in torch.tensor_split(rel, k, dim=1)]
    listed = sharding.sharded_sequence("imbe7200", mesh, int16=True)
    whole = sharding.sharded_sequence("imbe7200", mesh, int16=True)
    full = init
    for call in range(2):
        rounds = profiling.snapshot().get("mbe.shard.round", (0, 0))[0]
        shards, pcm, res = listed(split, shards, None if rel is None else rel_split)
        assert profiling.snapshot()["mbe.shard.round"][0] - rounds == T
        tensor_shards, t_pcm, t_res = whole(frames, tensor_shards, rel)
        full, ref_pcm, ref_res = pipeline.run_sequence("imbe7200", frames, full, rel, int16=True)
        for i in range(k):
            alone[i], a_pcm, a_res = pipeline.run_sequence("imbe7200", split[i], alone[i],
                                                           rel_split[i], int16=True)
            assert pcm[i].device == cuda_device and pcm[i].dtype == torch.int16
            assert torch.equal(pcm[i], a_pcm), (call, i)
            assert all(torch.equal(res[i][key], a_res[key]) for key in a_res), (call, i)
            assert all(torch.equal(x, y) for x, y in zip(_leaves(shards[i]), _leaves(alone[i])))
        assert torch.equal(t_pcm, torch.cat(pcm, dim=1))
        assert all(torch.equal(t_res[key], torch.cat([r[key] for r in res], 1)) for key in t_res)
        assert all(torch.equal(t_res[key], ref_res[key]) for key in ref_res)
        diff = (t_pcm.int() - ref_pcm.int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean().item() < 1e-3


@pytest.mark.cuda
def test_device_time_matmul_against_peak(cuda_device):
    """device_time (a graph of the body, replayed) of a bf16 4096 x 4096
    matmul: 137.4 GFLOP, 0.139 ms at the 989 TFLOP/s peak; the slope lies
    between 1.0x and 4x that (the reference's own check of its method)."""
    from mbe_tpu_torch.utils import profiling
    n = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = (torch.randn((n, n), device=cuda_device, generator=gen) / n ** 0.5).to(torch.bfloat16)
    x = torch.randn((n, n), device=cuda_device, generator=gen).to(torch.bfloat16)
    sec = profiling.device_time(lambda c: a @ c, x, iters=50, short_iters=10)
    peak = 2 * n ** 3 / 989e12
    assert 1.0 <= sec / peak <= 4.0, (sec, peak)


# --- tracing: region marks in the graphs, host spans ---------------------------

STEP_MARKS = {"imbe7200": ["bit_domain", "fsm", "synthesis", "commit", "end"],
              "ambe2450": ["bit_domain", "fsm", "synthesis", "fsm", "commit", "end"]}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_ops(fn, tmp_path):
    """Device operations (start_us, end_us, name, category) of fn() under
    torch.profiler with CUDA activities, sorted by start."""
    import json
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]),
                   str(e.get("cat", "")).lower()) for e in events
                  if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS)


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, hi = 0.0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total, hi = total + e - s, e
        elif e > hi:
            total, hi = total + e - hi, e
    return total


def _steps_by_region(ops):
    """Per step (a bit_domain mark after an end mark, or the first one, to
    the next end mark, both included): marks in order, region -> summed op
    us (the end mark's own time in none), and busy us, the union of the
    step's ops; and the ops outside every step."""
    steps, outside, cur, region = [], [], None, None
    for s, e, name, cat in ops:
        if name.startswith("mbe_region_"):
            r = name[len("mbe_region_"):]
            if cur is None:
                assert r == "bit_domain", name
                cur = {"marks": [], "us": {}, "ops": []}
            cur["marks"].append(r)
            region = r
            if r == "end":
                cur["ops"].append((s, e))
                cur["busy"] = _busy_us(cur.pop("ops"))
                steps.append(cur)
                cur = None
                continue
        if cur is None:
            outside.append((s, e, name, cat))
        else:
            cur["ops"].append((s, e))
            cur["us"][region] = cur["us"].get(region, 0.0) + (e - s)
    assert cur is None, "a step without its end mark"
    return steps, outside


@pytest.mark.cuda
@pytest.mark.parametrize("codec,soft", [("imbe7200", False), ("ambe2450", True)])
def test_region_marks_in_a_traced_replay_on_card(cuda_device, tmp_path, codec, soft):
    """Three traced CompiledStep replays at C = 4096: each holds the
    region marks in the step's order and mbe_region_end once; its four
    regions add up to its busy time (the union of its device ops, first
    mark to end mark) within 2%, and each is above 0; the mbe.graph.replay
    span counts one per replay."""
    from mbe_tpu_torch.utils import profiling
    C, reps = 4096, 3
    rng = np.random.default_rng(21)
    shape = (C, *pipeline.FRAME_SHAPES[codec])
    frame = torch.as_tensor(rng.integers(0, 2, shape), dtype=torch.int32, device=cuda_device)
    rel = (torch.as_tensor(rng.integers(0, 256, shape), dtype=torch.int32, device=cuda_device)
           if soft else None)
    compiled = pipeline.CompiledStep(codec, st.init_state(C, device=cuda_device), soft=soft,
                                     int16=True)
    compiled(frame, rel)
    torch.cuda.synchronize()
    count0 = profiling.snapshot()["mbe.graph.replay"][0]

    def replays():
        for _ in range(reps):
            compiled(frame, rel)

    steps, _ = _steps_by_region(_device_ops(replays, tmp_path))
    assert profiling.snapshot()["mbe.graph.replay"][0] - count0 == reps
    assert len(steps) == reps
    for step in steps:
        assert step["marks"] == STEP_MARKS[codec]
        regions = {r: step["us"].get(r, 0.0) for r in ("bit_domain", "fsm", "synthesis",
                                                        "commit")}
        assert all(v > 0 for v in regions.values()), regions
        assert abs(sum(regions.values()) - step["busy"]) <= 0.02 * step["busy"], (regions, step)


@pytest.mark.cuda
def test_region_marks_and_spans_in_traced_streaming_ticks_on_card(cuda_device, tmp_path):
    """Three traced StreamingDecoder ticks (imbe7200, C = 4096, depth 2,
    device unpack): each tick's graph marks bit_domain before its unpack,
    then the step's regions, and end once after the bundle; the tick's
    upload and readback copies lie outside every step; mbe.graph.replay
    and each mbe.stream.* span count one per tick."""
    from mbe_tpu_torch.parallel.streaming import StreamingDecoder
    from mbe_tpu_torch.utils import profiling
    C, ticks = 4096, 3
    rng = np.random.default_rng(22)
    pool = rng.integers(0, 256, (8, C, 23), dtype=np.uint8)
    dec = StreamingDecoder("imbe7200", C, rng_seed=np.arange(1, C + 1, dtype=np.uint32), depth=2,
                           device=cuda_device)
    for t in range(4):
        list(dec.push(pool[t]))
    torch.cuda.synchronize()
    names = ("mbe.graph.replay", "mbe.stream.stage", "mbe.stream.wait", "mbe.stream.copy_out")
    before = profiling.snapshot()
    got = []

    def push():
        for t in range(ticks):
            got.extend(dec.push(pool[4 + t]))

    steps, outside = _steps_by_region(_device_ops(push, tmp_path))
    after = profiling.snapshot()
    assert len(got) == ticks and len(steps) == ticks
    for name in names:
        assert after[name][0] - before[name][0] == ticks, name
    for step in steps:
        assert step["marks"] == ["bit_domain"] + STEP_MARKS["imbe7200"]
    copies = [op for op in outside if op[3] == "gpu_memcpy"]
    assert len(copies) == 2 * ticks, outside
    list(dec.flush())


@pytest.mark.cuda
def test_capture_raises_on_a_host_built_tensor(cuda_device, monkeypatch):
    """A step that uploads host data (the per-call constant that repair 0
    removed, put back) cannot be captured: CompiledStep raises, it does not
    fall back to eager execution. Last in the file: the failed capture is
    the last thing it asks of the card."""
    from mbe_tpu_torch.models import imbe
    from mbe_tpu_torch.ops import bits

    def uncached(n, device):
        return torch.as_tensor(np.array([1 << i for i in range(n)], np.int64), device=device)

    monkeypatch.setattr(imbe, "powers_of_two", uncached)
    with pytest.raises(RuntimeError):
        pipeline.CompiledStep("imbe7200", st.init_state(64, device=cuda_device))
    assert bits.powers_of_two(23, cuda_device).is_cuda
