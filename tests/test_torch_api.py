"""The port's public API (mbe_tpu_torch.api) against mbe_tpu.api and the
golden vectors.

Integers (bits, error counts, flags, integer state) bit-exact; PCM and
float state >= 60 dB SNR per frame, the bar tests/test_e2e.py sets. Every
port call runs on the CPU: numpy arguments go to device="cpu", tensors
and states are CPU tensors. Each JAX function is jitted once per family.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mbe_tpu_torch
from conftest import snr_db
from mbe_tpu import api as japi
from mbe_tpu.models import state as jst
from mbe_tpu_torch import api, pipeline
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.ops import bits
from mbe_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

CPU = "cpu"
NOTONES = DecoderConfig(tones_enabled=False)
INT_PARMS = ("L", "K", "Vl", "tonePhase", "swn", "amplitudeThreshold",
             "errorCountTotal", "errorCount4", "repeatCount")
FSM_FLAGS = (("erasure", api.PROCESS_FLAG_ERASURE), ("tone", api.PROCESS_FLAG_TONE),
             ("repeat", api.PROCESS_FLAG_REPEAT), ("mute", api.PROCESS_FLAG_MUTE))


def _assert_parms_close(got, want, msg):
    """Port Parms vs JAX Parms: integer leaves equal, float leaves >= 60 dB."""
    n = st.state_to_numpy(st.ChannelState(got, got, None, torch.zeros((3, 1), dtype=torch.int64),
                                          torch.zeros(1))).cur
    for k in st.PARMS_FIELDS:
        a, b = getattr(n, k), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype, f"{msg}: {k} {a.dtype} != {b.dtype}"
        if k in INT_PARMS:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {k}")
        else:
            assert snr_db(b, a) >= 60.0, f"{msg}: {k}"


def _assert_state_close(got, want, msg=""):
    for part in ("cur", "prev", "enh"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        if g is not None:
            _assert_parms_close(g, w, f"{msg} {part}")
    np.testing.assert_array_equal(got.comfort_rng.numpy().astype(np.uint32),
                                  np.asarray(want.comfort_rng))
    np.testing.assert_array_equal(got.lcg_prime.numpy(), np.asarray(want.lcg_prime))


# ---------------------------------------------------------------------------
# surface, constants, helpers
# ---------------------------------------------------------------------------

def test_reference_symbol_map_is_total():
    """The same 87 keys as mbe_tpu.api's map, every value a callable of the
    port (at the package top for mbe_versionString)."""
    assert set(api.REFERENCE_SYMBOL_MAP) == set(japi.REFERENCE_SYMBOL_MAP)
    assert len(api.REFERENCE_SYMBOL_MAP) == 87
    for ref_sym, ours in api.REFERENCE_SYMBOL_MAP.items():
        if ours.startswith("mbe_tpu_torch."):
            fn = getattr(mbe_tpu_torch, ours.split(".", 1)[1])
        else:
            fn = getattr(api, ours)
        assert callable(fn), f"{ref_sym} -> {ours}"


def test_version_and_constants():
    assert mbe_tpu_torch.version_string() == mbe_tpu_torch.__version__ == "0.1.0"
    for name in ("PROCESS_FLAG_SOFT_INPUT", "PROCESS_FLAG_C0_VALID", "PROCESS_FLAG_C4_VALID",
                 "PROCESS_FLAG_TONE", "PROCESS_FLAG_ERASURE", "PROCESS_FLAG_REPEAT",
                 "PROCESS_FLAG_MUTE", "STATUS_INVALID_ARGUMENT", "STATUS_INVALID_BITS",
                 "MAX_FRAME_REPEATS", "MUTING_THRESHOLD_IMBE", "MUTING_THRESHOLD_AMBE"):
        assert getattr(api, name) == getattr(japi, name), name
    assert pipeline.FRAME_SHAPES == {k: tuple(v) for k, v in
                                     __import__("mbe_tpu").pipeline.FRAME_SHAPES.items()}
    assert pipeline.DBITS == __import__("mbe_tpu").pipeline.DBITS


def test_format_process_result():
    """'='*errors then E,T,R,M in that order (mbelib.c:69-104)."""
    res = dict(total_errors=3, flags=api.PROCESS_FLAG_REPEAT | api.PROCESS_FLAG_MUTE)
    assert api.format_process_result(res) == "===RM"
    res = dict(total_errors=0, flags=api.PROCESS_FLAG_ERASURE | api.PROCESS_FLAG_TONE)
    assert api.format_process_result(res) == "ET"
    res = dict(total_errors=10, flags=api.PROCESS_FLAG_MUTE)
    assert api.format_process_result(res, size=5) == "===="
    assert api.format_process_result(dict(total_errors=-2, flags=0)) == ""
    # a result of one lane of the port's tensors formats as the reference's
    res = {k: torch.tensor(v) for k, v in japi.init_process_result().items()}
    assert api.format_process_result(res) == japi.format_process_result(
        japi.init_process_result()) == ""
    assert api.init_process_result() == japi.init_process_result()


def test_soft_bit_constructors():
    """mbe_softBitFromLlr: positive -> 1, |llr| clamped to 255
    (mbelib.c:125-132); numpy input goes to device=, tensors stay put."""
    bit, rel = api.soft_bit_from_llr(np.array([300, -300, 0, 5, -5]), device=CPU)
    assert bit.tolist() == [1, 0, 0, 1, 0] and rel.tolist() == [255, 255, 0, 5, 5]
    bit2, rel2 = api.soft_bits_from_llr(torch.tensor([300, -300, 0, 5, -5]))
    assert torch.equal(bit, bit2) and torch.equal(rel, rel2)
    bit, rel = api.soft_bits_from_hard(np.array([0, 1, 1]), 200, device=CPU)
    assert bit.tolist() == [0, 1, 1] and rel.tolist() == [200, 200, 200]
    bit, rel = api.soft_bit_from_hard(np.array([0, 3, 1]), device=CPU)
    jbit, jrel = japi.soft_bit_from_hard(np.array([0, 3, 1]))
    assert bit.tolist() == np.asarray(jbit).tolist() and rel.tolist() == np.asarray(jrel).tolist()


def test_init_mbe_parms_and_devices(monkeypatch):
    s = api.init_mbe_parms(channels=3, device=CPU)
    assert s.cur.Ml.shape == (57, 3) and s.cur.previousUw.shape == (128, 3)
    assert s.comfort_rng.shape == (3, 3)
    assert int(s.prev.L[0]) == 39 and int(s.prev.K[0]) == 12
    assert float(s.prev.noiseSeed[0]) == -1.0
    np.testing.assert_allclose(float(s.prev.mutingThreshold[0]), 0.0875, rtol=1e-6)
    # without a card the default device raises rather than running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: api.init_mbe_parms(2), lambda: api.golay2312(np.zeros((1, 23))),
                 lambda: api.synthesize_silencef(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a tensor argument keeps its own device
    out, errs = api.golay2312(torch.zeros((1, 23), dtype=torch.int32))
    assert out.device.type == "cpu" and int(errs[0]) == 0


def test_move_mbe_parms_is_a_copy():
    """The C copies the struct: the port clones every leaf."""
    s = api.init_mbe_parms(2, device=CPU)
    for fn in (api.move_mbe_parms, api.use_last_mbe_parms):
        p = fn(s.cur)
        for k in st.PARMS_FIELDS:
            assert torch.equal(getattr(p, k), getattr(s.cur, k))
            assert getattr(p, k).data_ptr() != getattr(s.cur, k).data_ptr(), k
        p.Ml += 1.0
        assert (s.cur.Ml == 1.0).all()


def test_validate_bits_host():
    assert bits.validate_bits_host(np.array([0, 1, 1, 0])) == bits.STATUS_OK
    assert bits.validate_bits_host(np.array([0, 2])) == bits.STATUS_INVALID_BITS
    assert bits.validate_bits_host(np.zeros(0)) == bits.STATUS_OK
    assert bits.validate_soft_bits_host(np.array([0, 1])) == bits.STATUS_OK
    assert bits.validate_soft_bits_host(np.array([-1, 1])) == bits.STATUS_INVALID_BITS


def test_resolve_total_errors():
    """mbe_result_resolve_total_errors semantics (mbe_result.h:76-99)."""
    res = dict(c0_errors=2, protected_errors=3, c4_errors=0, total_errors=0,
               flags=api.PROCESS_FLAG_C0_VALID)
    assert api.resolve_total_errors(res) == 5
    res["total_errors"] = 5
    assert api.resolve_total_errors(res) == 5
    assert api.resolve_total_errors(None) == 0
    res["total_errors"] = 1
    with pytest.raises(api.MbeInvalidArgument):
        api.resolve_total_errors(res)
    with pytest.raises(api.MbeInvalidArgument):
        api.resolve_total_errors(dict(c0_errors=200, protected_errors=0, c4_errors=0,
                                      total_errors=0, flags=0))
    with pytest.raises(api.MbeInvalidArgument):
        api.resolve_total_errors(dict(c0_errors=0, protected_errors=0, c4_errors=0,
                                      total_errors=0, flags=0x100))


# ---------------------------------------------------------------------------
# ECC wrappers and the staged decode
# ---------------------------------------------------------------------------

def test_ecc_wrappers_match_jax():
    """The bit-plane hard decoders, check_golay_block and the soft
    decoders (B2's plain version here) equal mbe_tpu.api's."""
    rng = np.random.default_rng(5)
    g, h = rng.integers(0, 2, (12, 23)), rng.integers(0, 2, (12, 15))
    rg, rh = rng.integers(0, 256, (12, 23)), rng.integers(0, 256, (12, 15))
    blocks = rng.integers(0, 1 << 24, 12)
    cases = [("golay2312", (g,)), ("golay2312_soft", (g, rg)), ("hamming1511", (h,)),
             ("hamming1511_soft", (h, rh)), ("hamming1511_7100x4400", (h,)),
             ("hamming1511_7100x4400_soft", (h, rh)), ("check_golay_block", (blocks,))]
    for name, args in cases:
        got = getattr(api, name)(*args, device=CPU)
        want = jax.jit(getattr(japi, name))(*(jnp.asarray(a, jnp.int32) for a in args))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _staged(codec, frame, rel):
    """ecc_c0 -> demodulate -> ecc_data (-> convert for imbe7100) through
    the port's API on CPU tensors."""
    if codec.startswith("ambe"):
        n = codec[4:]
        fr1, c0 = getattr(api, f"ecc_ambe3600x{n}_c0")(frame, rel)
        fr2 = getattr(api, f"demodulate_ambe3600x{n}_data")(fr1)
        d, prot = getattr(api, f"ecc_ambe3600x{n}_data")(fr2, rel)
        return d, c0, prot, None
    n = codec[4:]
    fr1, c0 = getattr(api, f"ecc_imbe{n}x4400_c0")(frame, rel)
    fr2 = getattr(api, f"demodulate_imbe{n}x4400_data")(fr1)
    d, prot, c4 = getattr(api, f"ecc_imbe{n}x4400_data")(fr2, rel)
    if codec == "imbe7100":
        d = api.convert_imbe7100to7200(d)
    return d, c0, prot, c4


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("codec", pipeline.CODECS)
def test_staged_equals_frame_decode(codec, soft):
    """The staged chain equals the fused decode_*_frame bit for bit (the
    reference's v2 staged flow, README.md:180-198), hard and soft; the
    result dict carries the reference's flags."""
    rng = np.random.default_rng(11 + pipeline.CODECS.index(codec))
    rows, cols = pipeline.FRAME_SHAPES[codec]
    frame = torch.as_tensor(rng.integers(0, 2, (8, rows, cols)), dtype=torch.int32)
    rel = torch.as_tensor(rng.integers(0, 256, (8, rows, cols)), dtype=torch.int32) if soft \
        else None
    name = {"imbe7200": "imbe7200x4400", "imbe7100": "imbe7100x4400",
            "ambe2450": "ambe3600x2450", "ambe2400": "ambe3600x2400"}[codec]
    if soft:
        d_ref, res = getattr(api, f"decode_{name}_soft_frame")(frame, rel)
    else:
        d_ref, res = getattr(api, f"decode_{name}_frame")(frame)
    d, c0, prot, c4 = _staged(codec, frame, rel)
    assert torch.equal(d, d_ref)
    assert torch.equal(c0, res["c0_errors"]) and torch.equal(prot, res["protected_errors"])
    assert torch.equal(res["total_errors"], c0 + prot)
    flags = api.PROCESS_FLAG_C0_VALID | (api.PROCESS_FLAG_SOFT_INPUT if soft else 0)
    if c4 is not None:
        assert torch.equal(c4, res["c4_errors"])
        flags |= api.PROCESS_FLAG_C4_VALID
    assert (res["flags"] == flags).all()


# ---------------------------------------------------------------------------
# JAX comparisons, one jitted JAX function per family
# ---------------------------------------------------------------------------

J_DECODE = {"imbe4400": jax.jit(japi.decode_imbe4400_parms),
            "ambe2450": jax.jit(japi.decode_ambe2450_parms),
            "ambe2400": jax.jit(japi.decode_ambe2400_parms)}


@pytest.mark.parametrize("family", ["imbe4400", "ambe2450", "ambe2400"])
def test_decode_parms_match_jax(family):
    """decode_*_parms over two random parameter frames in turn (the
    second predicts from the first): bad lanes and integer state exact,
    float state >= 60 dB."""
    c, nbits = 8, 88 if family == "imbe4400" else 49
    rng = np.random.default_rng(31)
    seeds = rng.integers(1, 2**32, c, dtype=np.uint64).astype(np.uint32)
    ours = api.init_mbe_parms(c, seeds, device=CPU)
    ref = jst.init_state(c, rng_seed=seeds)
    for t in range(2):
        d = rng.integers(0, 2, (c, nbits)).astype(np.int32)
        ours, bad = getattr(api, f"decode_{family}_parms")(d, ours)
        ref, jbad = J_DECODE[family](d, ref)
        np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad), err_msg=f"t={t}")
        _assert_state_close(ours, ref, f"t={t}")


def _decoded_states(c=8, seed=41):
    """A port state and the JAX one after one random IMBE parameter decode
    by JAX: voiced models with random L, Vl and Ml."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(1, 2**32, c, dtype=np.uint64).astype(np.uint32)
    ref, _ = J_DECODE["imbe4400"](rng.integers(0, 2, (c, 88)).astype(np.int32),
                                  jst.init_state(c, rng_seed=seeds))
    return st.state_from_numpy(jax.tree.map(np.asarray, ref), CPU), ref


def test_synthesize_speech_matches_jax():
    """synthesize_speechf (and the int16 synthesize_speech) over a decoded
    state: PCM >= 60 dB per lane, state as the JAX package's."""
    ours, ref = _decoded_states()
    audio, ours2 = api.synthesize_speechf(ours)
    jaudio, ref2 = jax.jit(japi.synthesize_speechf)(ref)
    for i in range(audio.shape[0]):
        assert snr_db(np.asarray(jaudio)[i], audio[i].numpy()) >= 60.0, i
    _assert_state_close(ours2, ref2)
    pcm16, _ = api.synthesize_speech(ours)
    assert torch.equal(pcm16, api.float_to_short(audio))


def test_comfort_noise_silence_and_helpers_match_jax():
    """Comfort noise (samples and RNG exact), silence, float_to_short on
    special values, the muting/smoothing predicates, adaptive smoothing
    and spectral enhancement, on a decoded state."""
    ours, ref = _decoded_states(seed=43)
    noise, ours_n = api.synthesize_comfort_noisef(ours)
    jnoise, ref_n = jax.jit(japi.synthesize_comfort_noisef)(ref)
    np.testing.assert_array_equal(noise.numpy(), np.asarray(jnoise))
    np.testing.assert_array_equal(ours_n.comfort_rng.numpy().astype(np.uint32),
                                  np.asarray(ref_n.comfort_rng))
    pcm16, _ = api.synthesize_comfort_noise(ours)
    assert torch.equal(pcm16, api.float_to_short(noise))
    assert torch.equal(api.synthesize_silencef(3, device=CPU), torch.zeros((3, 160)))
    assert api.synthesize_silence(3, device=CPU).dtype == torch.int16

    x = np.array([0.0, 1.5, -1.5, 5000.0, -5000.0, np.nan, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(api.float_to_short(x, device=CPU).numpy(),
                                  np.asarray(japi.float_to_short(jnp.asarray(x))))

    rng = np.random.default_rng(44)
    c = ours.cur.w0.shape[0]
    rate = rng.uniform(0.0, 0.2, c).astype(np.float32)
    total = rng.integers(0, 10, c).astype(np.int32)
    reps = rng.integers(0, 8, c).astype(np.int32)
    cur = dataclasses.replace(ours.cur, errorRate=torch.from_numpy(rate),
                              errorCountTotal=torch.from_numpy(total),
                              repeatCount=torch.from_numpy(reps))
    jcur = dataclasses.replace(ref.cur, errorRate=jnp.asarray(rate),
                               errorCountTotal=jnp.asarray(total), repeatCount=jnp.asarray(reps))
    for name in ("requires_muting", "is_max_frame_repeat", "requires_adaptive_smoothing"):
        np.testing.assert_array_equal(getattr(api, name)(cur).numpy(),
                                      np.asarray(getattr(japi, name)(jcur)), err_msg=name)
    _assert_parms_close(api.apply_adaptive_smoothing(cur, ours.prev),
                        jax.jit(japi.apply_adaptive_smoothing)(jcur, ref.prev), "smoothing")
    enh, rm0 = api.spectral_amp_enhance_parms(cur)
    jenh, jrm0 = jax.jit(japi.spectral_amp_enhance_parms)(jcur)
    _assert_parms_close(enh, jenh, "enhance")
    assert snr_db(np.asarray(jrm0), rm0.numpy()) >= 60.0


def test_synthesize_tones_match_jax():
    """synthesize_tonef on random and valid-tone parameter frames, and
    synthesize_tonef_dstar over valid and invalid ids: PCM >= 60 dB per
    lane, swn and tonePhase exact."""
    c = 8
    rng = np.random.default_rng(51)
    d = rng.integers(0, 2, (c, 49)).astype(np.int32)
    for i, tone in enumerate((5, 20, 122, 200)):  # ID1 at bits 12..19
        d[i, 12:20] = [(tone >> s) & 1 for s in range(7, -1, -1)]
    seeds = np.arange(1, c + 1, dtype=np.uint32)
    ours = api.init_mbe_parms(c, seeds, device=CPU)
    ref = jst.init_state(c, rng_seed=seeds)
    ids = np.array([0, 5, 6, 7, 50, 122, 123, 255], np.int32)
    for t in range(2):  # the second call continues the phases of the first
        audio, ours = api.synthesize_tonef(d, ours)
        jaudio, ref = jax.jit(japi.synthesize_tonef)(d, ref)
        audio_d, ours = api.synthesize_tonef_dstar(ours, ids)
        jaudio_d, ref = jax.jit(japi.synthesize_tonef_dstar)(ref, ids)
        for a, b in ((audio, jaudio), (audio_d, jaudio_d)):
            for i in range(c):
                assert snr_db(np.asarray(b)[i], a[i].numpy()) >= 60.0, (t, i)
        for k in ("swn", "tonePhase"):
            np.testing.assert_array_equal(getattr(ours.cur, k).numpy(),
                                          np.asarray(getattr(ref.cur, k)), err_msg=k)


def test_set_rng_seed_matches_jax():
    seeds = np.array([0, 1, 12345, 0x6D25357B, 0xFFFFFFFF, 53125], np.uint32)
    ours = api.set_rng_seed(api.init_mbe_parms(6, device=CPU), seeds)
    ref = jax.jit(japi.set_rng_seed)(jst.init_state(6), seeds)
    _assert_state_close(ours, ref)
    # a tensor seed and a scalar seed
    ours_t = api.set_rng_seed(api.init_mbe_parms(6, device=CPU),
                              torch.from_numpy(seeds.astype(np.int64)))
    assert torch.equal(ours_t.comfort_rng, ours.comfort_rng)
    ours_s = api.set_rng_seed(api.init_mbe_parms(6, device=CPU), 7)
    ref_s = japi.set_rng_seed(jst.init_state(6), 7)
    _assert_state_close(ours_s, ref_s)


def test_dump_strings_match_jax():
    """Every dump_* string equals mbe_tpu.api's, from numpy and from tensors."""
    rng = np.random.default_rng(61)
    args = {"dump_ambe2450_data": (49,), "dump_ambe2400_data": (49,),
            "dump_ambe3600x2450_frame": (4, 24), "dump_ambe3600x2400_frame": (4, 24),
            "dump_imbe4400_data": (88,), "dump_imbe7200x4400_data": (88,),
            "dump_imbe7100x4400_data": (88,), "dump_imbe7200x4400_frame": (8, 23),
            "dump_imbe7100x4400_frame": (7, 24)}
    for name, shape in args.items():
        x = rng.integers(0, 2, shape).astype(np.int32)
        want = getattr(japi, name)(x)
        assert getattr(api, name)(x) == want, name
        assert getattr(api, name)(torch.from_numpy(x)) == want, name


# ---------------------------------------------------------------------------
# process paths: frames, data entry, configuration
# ---------------------------------------------------------------------------

def _flags(fsm):
    return sum(bit for name, bit in FSM_FLAGS if name in fsm and bool(fsm[name][0]))


DATAF = {"imbe7200": api.process_imbe4400_dataf, "ambe2450": api.process_ambe2450_dataf,
         "ambe2400": api.process_ambe2400_dataf}


@pytest.mark.parametrize("name", ["fsm_imbe7200", "fsm_ambe2450", "fsm_ambe2400",
                                  "fsm_notones_ambe2450", "fsm_notones_ambe2400"])
def test_fsm_data_goldens(vectors, name):
    """The crafted parameter streams through process_*_dataf with no C0
    or C4 count (the Data fallback rules; fsm_imbe7200 walks IMBE's
    total_errors > 5 repeat rule): flags exact, >= 60 dB per frame; a
    tone-play frame with tones off is exact silence."""
    vec = vectors(name)
    codec = name.rsplit("_", 1)[1]
    tones = "notones" not in name
    state = api.init_mbe_parms(1, np.uint32(vec["seed"]), device=CPU)
    hit, silent = set(), 0
    for t in range(vec["dbits"].shape[0]):
        audio, state, fsm = DATAF[codec](vec["dbits"][t][None], state,
                                         np.array([vec["totals"][t]], np.int32),
                                         config=DecoderConfig(tones_enabled=tones))
        flags = _flags(fsm)
        hit |= {n for n, b in FSM_FLAGS if flags & b}
        assert flags == int(vec["flags"][t]), f"t={t}: flags {flags:#x}"
        assert int(fsm["status"][0]) == 0 and audio.shape == (1, 160)
        if not tones and flags == api.PROCESS_FLAG_TONE and not vec["pcm"][t].any():
            assert (audio == 0).all()
            silent += 1
        else:
            s = snr_db(vec["pcm"][t], audio[0].numpy())
            assert s >= 60.0, f"t={t}: SNR {s:.1f} dB"
    assert {"repeat", "mute"} <= hit
    if codec == "ambe2450":
        assert {"tone", "erasure"} <= hit
        assert silent >= (0 if tones else 2)


def test_imbe_data_counts_match_jax():
    """process_imbe4400_dataf with C0 and C4 counts, as numpy and as
    tensors, against mbe_tpu.api's: repeat and mute flags and state exact,
    PCM >= 60 dB (the counts-unknown rule is held by fsm_imbe7200 above)."""
    c = 6
    rng = np.random.default_rng(71)
    te = np.array([0, 3, 6, 9, 20, 40], np.int32)
    c0 = np.array([0, 1, 2, 3, 2, 2], np.int32)
    c4 = np.array([0, 1, 0, 1, 1, 0], np.int32)
    seeds = np.arange(3, 3 + c, dtype=np.uint32)
    jrun = jax.jit(lambda d, s, te, c0, c4: japi.process_imbe4400_dataf(d, s, te, c0, c4))
    ours = api.init_mbe_parms(c, seeds, device=CPU)
    ref = jst.init_state(c, rng_seed=seeds)
    for t in range(2):
        d = rng.integers(0, 2, (c, 88)).astype(np.int32)
        args = (te, c0, c4) if t == 0 else tuple(torch.from_numpy(x) for x in (te, c0, c4))
        audio, ours, fsm = api.process_imbe4400_dataf(d, ours, *args)
        jaudio, ref, jfsm = jrun(d, ref, jnp.asarray(te), jnp.asarray(c0), jnp.asarray(c4))
        for k in ("repeat", "mute", "status"):
            np.testing.assert_array_equal(fsm[k].numpy(), np.asarray(jfsm[k]),
                                          err_msg=f"t={t} {k}")
        for i in range(c):
            assert snr_db(np.asarray(jaudio)[i], audio[i].numpy()) >= 60.0, (t, i)
        _assert_state_close(ours, ref, f"t={t}")
    pcm16, _, _ = api.process_imbe4400_data(d, ours, te)
    assert pcm16.dtype == torch.int16


def test_notones_tone_state_untouched():
    """A valid tone frame with tones disabled: silence out, flags as with
    tones on, swn and tonePhase not advanced (mbelib.c:747-751)."""
    d = np.zeros((1, 49), np.int32)
    d[0, 0:6] = 1                                   # u0 tone check
    d[0, 12:20] = [(20 >> s) & 1 for s in range(7, -1, -1)]  # ID1 = 20
    d[0, 6:12] = 1                                  # nonzero amplitude AD
    te = np.zeros(1, np.int32)
    st_on = api.init_mbe_parms(1, np.uint32(7), device=CPU)
    st_off = api.init_mbe_parms(1, np.uint32(7), device=CPU)
    audio_on, st2_on, fsm_on = api.process_ambe2450_dataf(d, st_on, te)
    audio_off, st2_off, fsm_off = api.process_ambe2450_dataf(d, st_off, te, config=NOTONES)
    assert bool(fsm_on["tone"][0]) and bool(fsm_off["tone"][0])
    assert (audio_on != 0).any() and (audio_off == 0).all()
    assert torch.equal(st2_off.cur.swn, st_off.cur.swn)
    assert torch.equal(st2_off.cur.tonePhase, st_off.cur.tonePhase)
    assert not (torch.equal(st2_on.cur.swn, st_on.cur.swn)
                and torch.equal(st2_on.cur.tonePhase, st_on.cur.tonePhase))
    for k in st.PARMS_FIELDS:
        if k not in ("swn", "tonePhase"):
            assert torch.equal(getattr(st2_on.cur, k), getattr(st2_off.cur, k)), k


def test_config_framef_wrapper(vectors):
    """config= reaches the full frame path through process_*_framef: the
    default and NOTONES configs agree on non-tone voice frames."""
    vec = vectors("e2e_ambe2450")
    frame = vec["frames"][0]
    state = api.init_mbe_parms(frame.shape[0], vec["seeds"], device=CPU)
    _, audio_def, res_def, _ = api.process_ambe3600x2450_framef(frame, state)
    _, audio_nt, res_nt, _ = api.process_ambe3600x2450_framef(frame, state, config=NOTONES)
    assert torch.equal(audio_def, audio_nt) and torch.equal(res_def["flags"], res_nt["flags"])


def test_config_int16_output(vectors):
    """int16_output=True turns the framef wrapper's PCM into int16, equal
    to process_*_frame's; within 1 LSB of the reference's int16 on under
    2% of samples (float op order, tests/test_config.py)."""
    vec = vectors("e2e_imbe7200")
    frame = vec["frames"][0]
    state = api.init_mbe_parms(frame.shape[0], vec["seeds"], device=CPU)
    _, pcm16, _, _ = api.process_imbe7200x4400_framef(
        frame, state, config=DecoderConfig(int16_output=True))
    assert pcm16.dtype == torch.int16
    _, pcm16_frame, _, _ = api.process_imbe7200x4400_frame(frame, state)
    _, audio, _, _ = api.process_imbe7200x4400_framef(frame, state)
    assert torch.equal(pcm16, pcm16_frame) and torch.equal(pcm16, api.float_to_short(audio))
    diff = np.abs(pcm16.numpy().astype(np.int32) - vec["pcm16"][0].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


@pytest.mark.parametrize("codec", pipeline.CODECS)
def test_framef_entry_points_match_step(vectors, codec):
    """The four codecs' process_*_framef, _frame and the _soft_ variants
    (soft_rel before the state) equal pipeline.step and step_int16 on the
    e2e goldens' first frame, and the golden itself."""
    name = {"imbe7200": "imbe7200x4400", "imbe7100": "imbe7100x4400",
            "ambe2450": "ambe3600x2450", "ambe2400": "ambe3600x2400"}[codec]
    for soft in (False, True):
        vec = vectors(f"e2e_{codec}_soft" if soft else f"e2e_{codec}")
        frame, rel = vec["frames"][0], vec["rel"][0] if soft else None
        state = api.init_mbe_parms(frame.shape[0], vec["seeds"], device=CPU)
        want = pipeline.step(codec, torch.from_numpy(frame), state,
                             None if rel is None else torch.from_numpy(rel))
        if soft:
            got = getattr(api, f"process_{name}_soft_framef")(frame, rel, state)
            got16 = getattr(api, f"process_{name}_soft_frame")(frame, rel, state)
        else:
            got = getattr(api, f"process_{name}_framef")(frame, state)
            got16 = getattr(api, f"process_{name}_frame")(frame, state)
        assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
        assert torch.equal(got16[1], api.float_to_short(want[1]))
        for k in want[2]:
            assert torch.equal(got[2][k], want[2][k]), k
        np.testing.assert_array_equal(got[2]["flags"].numpy(), vec["flags"][0])
        for i in range(frame.shape[0]):
            assert snr_db(vec["pcm"][0, i], got[1][i].numpy()) >= 60.0, (soft, i)


# ---------------------------------------------------------------------------
# host validation (tests/test_fuzz.py) and tensor inputs
# ---------------------------------------------------------------------------

RAW_VALUES = np.array([0, 1, 2, 127, 255, -1, -128], np.int32)


def test_invalid_bits_rejected_on_host():
    bad = np.zeros((4, 24), np.int32)
    bad[0, 0] = 2
    assert bits.validate_bits_host(bad) == bits.STATUS_INVALID_BITS
    assert bits.validate_soft_bits_host(bad) == bits.STATUS_INVALID_BITS
    assert bits.validate_bits_host(np.ones((4, 24), np.int32)) == bits.STATUS_OK


@pytest.mark.parametrize("name,shape", [("imbe7200x4400", (8, 23)),
                                        ("ambe3600x2450", (4, 24))])
def test_raw_byte_frames_rejected_on_host(name, shape):
    rng = np.random.default_rng(7)
    state = api.init_mbe_parms(2, device=CPU)
    fn = getattr(api, f"process_{name}_framef")
    for _ in range(8):
        frame = rng.choice(RAW_VALUES, size=(2,) + shape).astype(np.int32)
        if not ((frame == 0) | (frame == 1)).all():
            with pytest.raises(api.MbeInvalidBits):
                fn(frame, state)


def test_raw_byte_dbits_rejected_on_host():
    state = api.init_mbe_parms(1, device=CPU)
    te = np.zeros(1, np.int32)
    bad49 = np.zeros((1, 49), np.int32)
    bad49[0, 3] = 255
    for fn in (api.process_ambe2450_dataf, api.process_ambe2400_dataf):
        with pytest.raises(api.MbeInvalidBits):
            fn(bad49, state, te)
    bad88 = np.zeros((1, 88), np.int32)
    bad88[0, 80] = -1
    with pytest.raises(api.MbeInvalidBits):
        api.process_imbe4400_dataf(bad88, state, te)


def test_inconsistent_result_counters_rejected():
    """mbe_result_resolve_total_errors on Data entry (mbe_result.h:76-114)."""
    state = api.init_mbe_parms(1, device=CPU)
    d = np.zeros((1, 49), np.int32)
    for te, c0 in ((185, None), (-1, None), (1, 3)):
        with pytest.raises(api.MbeInvalidArgument):
            api.process_ambe2450_dataf(d, state, np.array([te], np.int32),
                                       c0_errors=None if c0 is None else np.array([c0], np.int32))
    with pytest.raises(api.MbeInvalidArgument):
        api.process_imbe4400_dataf(np.zeros((1, 88), np.int32), state, np.array([1], np.int32),
                                   c4_errors=np.array([2], np.int32))
    audio, _, _ = api.process_ambe2450_dataf(d, state, np.array([0], np.int32),
                                             c0_errors=np.array([2], np.int32))
    assert torch.isfinite(audio).all()


def test_out_of_range_soft_reliability_rejected_on_host():
    frame = np.zeros((1, 4, 24), np.int32)
    rel = np.full((1, 4, 24), 255, np.int32)
    for v in (256, -7):
        rel[0, 0, 0] = v
        with pytest.raises(api.MbeInvalidArgument):
            api.process_ambe3600x2450_framef(frame, api.init_mbe_parms(1, device=CPU), rel)


def test_tensor_inputs_skip_host_validation(vectors):
    """Tensors are not read back: a frame or parameter lane with a bad
    bit reports status -2, silence and its state rolled back, the other
    lanes as from clean input."""
    vec = vectors("e2e_imbe7200")
    frame = torch.from_numpy(vec["frames"][0][:2].copy())
    state = api.init_mbe_parms(2, vec["seeds"][:2], device=CPU)
    _, audio_ref, _, _ = api.process_imbe7200x4400_framef(frame, state)
    bad = frame.clone()
    bad[1, 2, 5] = 200
    st_mix, audio, res, _ = api.process_imbe7200x4400_framef(bad, state)
    assert res["status"].tolist() == [0, -2]
    assert torch.equal(audio[0], audio_ref[0]) and (audio[1] == 0).all()
    assert torch.equal(st_mix.cur.Ml[:, 1], state.cur.Ml[:, 1])

    d = torch.zeros((2, 49), dtype=torch.int32)
    d[1, 7] = 3
    st_a = api.init_mbe_parms(2, np.uint32(5), device=CPU)
    audio, st_b, fsm = api.process_ambe2450_dataf(d, st_a, torch.zeros(2, dtype=torch.int32))
    assert fsm["status"].tolist() == [0, -2] and (audio[1] == 0).all()
    assert not bool(fsm["repeat"][1] | fsm["mute"][1] | fsm["tone"][1])
    for k in st.PARMS_FIELDS:
        assert torch.equal(getattr(st_b.cur, k)[..., 1], getattr(st_a.cur, k)[..., 1]), k
    assert torch.equal(st_b.comfort_rng[:, 1], st_a.comfort_rng[:, 1])


class _NoReadback(torch.overrides.TorchFunctionMode):
    """Fails on any tensor-to-host read: the process paths must not sync
    the stream."""
    BANNED = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy,
              torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"host read-back by {func.__name__}")
        return func(*args, **(kwargs or {}))


def test_process_paths_read_nothing_back(vectors):
    """The frame and Data paths, given tensors, make no host read-back
    (no .item(), .cpu(), bool() of a tensor ...) in the API layer or below
    it, so on the card they never stall the stream."""
    vec = vectors("e2e_ambe2450_soft")
    frame, rel = torch.from_numpy(vec["frames"][0]), torch.from_numpy(vec["rel"][0])
    state = api.init_mbe_parms(frame.shape[0], vec["seeds"], device=CPU)
    d = torch.zeros((frame.shape[0], 88), dtype=torch.int32)
    te = torch.zeros(frame.shape[0], dtype=torch.int32)
    with _NoReadback():
        api.process_ambe3600x2450_soft_frame(frame, rel, state)
        api.process_imbe4400_data(d, state, te, te, te)
        api.process_ambe2400_dataf(d[:, :49], state, te)
