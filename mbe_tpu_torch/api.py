"""1:1 mirror of the reference public API (include/mbelib-neo/mbelib.h);
port of mbe_tpu.api with the same names and REFERENCE_SYMBOL_MAP keys.

Naming: `mbe_processImbe7200x4400Framef` -> `process_imbe7200x4400_framef`
etc. Every function works on batched tensors ([C, ...]) and threads the
`ChannelState` functionally instead of mutating caller-owned structs; with
C == 1 these are drop-in equivalents of the single-stream reference calls.

Devices: a function that takes a ChannelState runs on the state's device
and moves its other arguments there. A stateless function keeps a tensor
argument on its own device; a numpy (or list, or scalar) argument goes to
`device=`, the GPU by default, which raises without one.

Status semantics: where the reference returns MBE_STATUS_INVALID_ARGUMENT
or MBE_STATUS_INVALID_BITS, numpy inputs are validated on the host and
raise `MbeInvalidBits` / `MbeInvalidArgument`. Tensor inputs skip host
validation, as traced arrays do in the JAX package: reading a device
tensor back would stall the stream once per call. The step's per-lane
status (-2, silence, state rolled back) covers them.
"""

import dataclasses

import numpy as np
import torch

from . import pipeline
from .models import ambe, imbe, speech
from .models import state as state_mod
from .models.state import ChannelState, Parms, checked_device, map_parms, map_state
from .ops import bits as bit_ops
from .ops import demod, ecc, noise
from .ops import synth as synth_ops
from .ops.enhance import adaptive_smoothing, spectral_amp_enhance
from .utils.config import DEFAULT as DEFAULT_CONFIG, DecoderConfig  # noqa: F401

# --- status / constants (mbelib.h:153-191, 679-686) ------------------------

PROCESS_FLAG_SOFT_INPUT = pipeline.FLAG_SOFT_INPUT
PROCESS_FLAG_C0_VALID = pipeline.FLAG_C0_VALID
PROCESS_FLAG_C4_VALID = pipeline.FLAG_C4_VALID
PROCESS_FLAG_TONE = pipeline.FLAG_TONE
PROCESS_FLAG_ERASURE = pipeline.FLAG_ERASURE
PROCESS_FLAG_REPEAT = pipeline.FLAG_REPEAT
PROCESS_FLAG_MUTE = pipeline.FLAG_MUTE

STATUS_INVALID_ARGUMENT = bit_ops.STATUS_INVALID_ARGUMENT
STATUS_INVALID_BITS = bit_ops.STATUS_INVALID_BITS

MAX_FRAME_REPEATS = state_mod.MAX_FRAME_REPEATS
MUTING_THRESHOLD_IMBE = state_mod.MUTING_THRESHOLD_IMBE
MUTING_THRESHOLD_AMBE = state_mod.MUTING_THRESHOLD_AMBE


class MbeInvalidBits(ValueError):
    """Input bits contained values other than 0/1 (MBE_STATUS_INVALID_BITS)."""


class MbeInvalidArgument(ValueError):
    """Invalid argument (MBE_STATUS_INVALID_ARGUMENT)."""


def _check_bits(arr):
    if bit_ops.validate_bits_host(arr) != bit_ops.STATUS_OK:
        raise MbeInvalidBits("bits must be 0 or 1")


def _tensor(x, dtype=torch.int32, device="cuda"):
    """x as a `dtype` tensor: a tensor stays on its device, anything else
    goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=checked_device(device))


def _on_state(x, st: ChannelState, dtype=torch.int32):
    """x as a `dtype` tensor on the state's device."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           dtype=dtype, device=st.lcg_prime.device)


def _lanes(x, st: ChannelState):
    """A per-channel int32 count ([C] or a scalar) as a [C] tensor on the
    state's device."""
    return _on_state(x, st).expand(st.lcg_prime.shape[0]).contiguous()


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- result helpers (mbelib.c:61-104) ---------------------------------------

def init_process_result():
    z = np.int32(0)
    return dict(c0_errors=z, protected_errors=z, c4_errors=z,
                total_errors=z, flags=np.int32(0))


def format_process_result(result, size=256) -> str:
    """mbe_formatProcessResult (mbelib.c:69-104): '='*total then E,T,R,M."""
    total = max(int(result["total_errors"]), 0)
    flags = int(result["flags"])
    out = []
    for _ in range(total):
        if len(out) + 1 >= size:
            break
        out.append("=")
    for flag, ch in ((PROCESS_FLAG_ERASURE, "E"), (PROCESS_FLAG_TONE, "T"),
                     (PROCESS_FLAG_REPEAT, "R"), (PROCESS_FLAG_MUTE, "M")):
        if flags & flag and len(out) + 1 < size:
            out.append(ch)
    return "".join(out)


# --- soft-bit helpers (mbelib.c:117-158) ------------------------------------

def soft_bit_from_llr(llr, device="cuda"):
    """mbe_softBitFromLlr: (bit, reliability) int32."""
    return bit_ops.soft_bit_from_llr(_tensor(llr, device=device))


def soft_bits_from_hard(bits, reliability=255, device="cuda"):
    return bit_ops.soft_bits_from_hard(_tensor(bits, device=device), reliability)


def soft_bit_from_hard(bit, reliability=255, device="cuda"):
    b = _tensor(bit, device=device)
    return (b != 0).to(torch.int32), torch.broadcast_to(
        _tensor(reliability, device=b.device), b.shape)


def soft_bits_from_llr(llr, device="cuda"):
    return soft_bit_from_llr(llr, device)


# --- ECC (ecc.c) -------------------------------------------------------------

def check_golay_block(block, device="cuda"):
    return ecc.check_golay_block(_tensor(block, device=device))


def golay2312(bits, device="cuda"):
    return ecc.golay2312_hard(_tensor(bits, device=device))


def golay2312_soft(bits, rel, device="cuda"):
    bits = _tensor(bits, device=device)
    return ecc.golay2312_soft(bits, _tensor(rel, device=bits.device))


def hamming1511(bits, device="cuda"):
    return ecc.hamming1511_hard(_tensor(bits, device=device), variant7100=False)


def hamming1511_soft(bits, rel, device="cuda"):
    bits = _tensor(bits, device=device)
    return ecc.hamming1511_soft(bits, _tensor(rel, device=bits.device), variant7100=False)


def hamming1511_7100x4400(bits, device="cuda"):
    return ecc.hamming1511_hard(_tensor(bits, device=device), variant7100=True)


def hamming1511_7100x4400_soft(bits, rel, device="cuda"):
    bits = _tensor(bits, device=device)
    return ecc.hamming1511_soft(bits, _tensor(rel, device=bits.device), variant7100=True)


# --- core state management (mbelib.c:338-410) --------------------------------

def init_mbe_parms(channels=1, rng_seed=None, device="cuda") -> ChannelState:
    """mbe_initMbeParms + mbe_setThreadRngSeed, batched, on `device`."""
    return state_mod.init_state(channels, rng_seed, device=device)


def set_rng_seed(st: ChannelState, seed) -> ChannelState:
    """mbe_setThreadRngSeed (mbelib.c:173-181): reseeds the comfort-noise
    RNG and arms the unvoiced LCG cold-start override, per channel."""
    rng, lcg_prime = state_mod.seeded_rngs(seed, st.lcg_prime.shape[0], st.lcg_prime.device)
    return dataclasses.replace(st, comfort_rng=rng, lcg_prime=lcg_prime)


def move_mbe_parms(src: Parms) -> Parms:
    """mbe_moveMbeParms: a copy. Tensors are mutable, so the copy is a
    clone of every leaf, never an alias."""
    return map_parms(torch.clone, src)


use_last_mbe_parms = move_mbe_parms


# --- synthesis (mbelib.c:641-1132, mbe_adaptive.c:117-149) -------------------

def synthesize_silencef(channels, device="cuda"):
    return torch.zeros((channels, 160), dtype=torch.float32, device=checked_device(device))


def synthesize_silence(channels, device="cuda"):
    return torch.zeros((channels, 160), dtype=torch.int16, device=checked_device(device))


def synthesize_comfort_noisef(st: ChannelState):
    """mbe_synthesizeComfortNoisef: returns (samples [C, 160], state')."""
    samples, rng = noise.comfort_noise(st.comfort_rng)
    return samples.T, dataclasses.replace(st, comfort_rng=rng)


def synthesize_comfort_noise(st: ChannelState):
    samples, st = synthesize_comfort_noisef(st)
    return synth_ops.float_to_short(samples), st


def synthesize_speechf(st: ChannelState):
    """mbe_synthesizeSpeechf over (cur, prev): returns (audio, state')."""
    rm0 = speech.current_frame_rm0(st.cur)
    cn, new_rng = noise.comfort_noise(st.comfort_rng)
    audio, cur, prev, aux = speech.synthesize_speech_core(st.cur, st.prev, cn, st.lcg_prime, rm0)
    rng = torch.where(aux["mute"][None, :], new_rng, st.comfort_rng)
    lcgp = torch.where(aux["cold_consumed"], noise.LCG_DEFAULT_SEED, st.lcg_prime)
    return audio.T, dataclasses.replace(st, cur=cur, prev=prev, comfort_rng=rng, lcg_prime=lcgp)


def synthesize_speech(st: ChannelState):
    audio, st = synthesize_speechf(st)
    return synth_ops.float_to_short(audio), st


def synthesize_tonef(ambe_d, st: ChannelState):
    """mbe_synthesizeTonef (mbelib.c:745-804): returns (audio, state').
    ambe_d follows the public [C, 49] contract."""
    ad, id1 = synth_ops.parse_tone_fields(_on_state(ambe_d, st).T)
    audio, swn, tp = synth_ops.render_tone(id1, ad, st.cur.swn, st.cur.tonePhase)
    cur = dataclasses.replace(st.cur, swn=swn, tonePhase=tp)
    return audio.T, dataclasses.replace(st, cur=cur)


def synthesize_tonef_dstar(st: ChannelState, id1):
    """mbe_synthesizeTonefdstar (mbelib.c:813-856): AD=103, single tones."""
    id1 = _on_state(id1, st)
    valid = (id1 == 5) | (id1 == 6) | ((id1 >= 7) & (id1 <= 122))
    tid = torch.where(valid, id1, 0)
    audio, swn, tp = synth_ops.render_tone(tid, torch.full_like(id1, 103), st.cur.swn,
                                           st.cur.tonePhase)
    cur = dataclasses.replace(st.cur, swn=swn, tonePhase=tp)
    return audio.T, dataclasses.replace(st, cur=cur)


def float_to_short(samples, device="cuda"):
    """mbe_floattoshort: gain 7, clip, NaN -> 0, truncation (int16)."""
    return synth_ops.float_to_short(_tensor(samples, torch.float32, device))


def requires_muting(p: Parms):
    """mbe_requiresMuting (mbe_adaptive.c:87-93)."""
    return p.errorRate > p.mutingThreshold


def is_max_frame_repeat(p: Parms):
    """mbe_isMaxFrameRepeat (mbe_adaptive.c:101-107)."""
    return p.repeatCount >= MAX_FRAME_REPEATS


def requires_adaptive_smoothing(p: Parms):
    """mbe_requiresAdaptiveSmoothing (mbe_adaptive.c:70-76)."""
    return (p.errorRate > 0.0125) | (p.errorCountTotal > 4)


def apply_adaptive_smoothing(cur: Parms, prev: Parms):
    """mbe_applyAdaptiveSmoothing (mbe_adaptive.c:268-276)."""
    rm0 = speech.current_frame_rm0(cur)
    Ml, Vl, le, at = adaptive_smoothing(
        cur.Ml, cur.Vl, cur.L, cur.errorRate, cur.errorCountTotal,
        cur.errorCount4, prev.localEnergy, prev.amplitudeThreshold, rm0)
    return dataclasses.replace(cur, Ml=Ml, Vl=Vl, localEnergy=le, amplitudeThreshold=at)


def spectral_amp_enhance_parms(cur: Parms):
    """mbe_spectralAmpEnhance[WithRm0] (mbelib.c:641-666)."""
    Ml, rm0 = spectral_amp_enhance(cur.w0, cur.L, cur.Ml)
    return dataclasses.replace(cur, Ml=Ml), rm0


# --- per-codec stage functions ----------------------------------------------
# The reference's staged mbe_ecc*/mbe_demodulate*/mbe_decode* contracts on
# [C, rows, cols] bit planes: callers see the frame mutations the C makes
# between stages. The fused decoders (models/*.decode_*_frame) work on
# packed words; tests/test_torch_api.py holds the staged chains equal to
# them for every codec, hard and soft.

def _soft_or_hard_golay(bits, rel):
    return ecc.golay2312_hard(bits) if rel is None else ecc.golay2312_soft(bits, rel)


def _soft_or_hard_hamming(bits, rel, variant7100=False):
    if rel is None:
        return ecc.hamming1511_hard(bits, variant7100)
    return ecc.hamming1511_soft(bits, rel, variant7100)


def _frame_rel(frame, soft_rel, device):
    f = _tensor(frame, device=device)
    return f, None if soft_rel is None else _tensor(soft_rel, device=f.device)


def _ambe_c0(frame, soft_rel=None, device="cuda"):
    """mbe_eccAmbe3600x24xxC0: Golay over fr[0][1..23] and the Golay24
    parity fix of fr[0][0]. Returns (frame', c0_errors)."""
    f, rel = _frame_rel(frame, soft_rel, device)
    g_out, errs = _soft_or_hard_golay(f[:, 0, 1:24], None if rel is None else rel[:, 0, 1:24])
    bit0, errs = ambe.golay24_parity_fix(f[:, 0, 0], g_out.sum(dim=-1), errs)
    out = f.clone()
    out[:, 0, 0] = bit0
    out[:, 0, 1:24] = g_out
    return out, errs


ecc_ambe3600x2450_c0 = _ambe_c0
ecc_ambe3600x2400_c0 = _ambe_c0


def _ambe_demod(frame, device="cuda"):
    """mbe_demodulateAmbe3600x24xxData (ambe_common.c:75-100): XOR C1 with
    the keystream seeded from C0 bits 23..12. Returns frame'."""
    f = _tensor(frame, device=device)
    pr = demod.prng_bits(16 * bit_ops.pack_descending(f[:, 0, :], 23, 12), 23).T
    out = f.clone()
    out[:, 1, :23] = f[:, 1, :23] ^ pr.flip(-1).to(torch.int32)
    return out


demodulate_ambe3600x2450_data = _ambe_demod
demodulate_ambe3600x2400_data = _ambe_demod


def _ambe_ecc_data(frame, soft_rel=None, device="cuda"):
    """mbe_eccAmbe3600x24xxData (ambe_common.c:127-189): Golay C1 + 49-bit
    packing. Returns (ambe_d [C, 49], protected_errors [C])."""
    f, rel = _frame_rel(frame, soft_rel, device)
    g1, errs = _soft_or_hard_golay(f[:, 1, :23], None if rel is None else rel[:, 1, :23])
    ambe_d = torch.cat([f[:, 0, 12:24].flip(-1), g1[:, 11:23].flip(-1),
                        f[:, 2, :11].flip(-1), f[:, 3, :14].flip(-1)], dim=-1)
    return ambe_d, errs


ecc_ambe3600x2450_data = _ambe_ecc_data
ecc_ambe3600x2400_data = _ambe_ecc_data


def ecc_imbe7200x4400_c0(frame, soft_rel=None, device="cuda"):
    """mbe_eccImbe7200x4400C0 (imbe7200x4400.c:424-460): Golay on row 0.
    Returns (frame', c0_errors)."""
    f, rel = _frame_rel(frame, soft_rel, device)
    g_out, errs = _soft_or_hard_golay(f[:, 0, :], None if rel is None else rel[:, 0, :])
    out = f.clone()
    out[:, 0, :] = g_out
    return out, errs


def _xor_keystream(f, pr, rows):
    """Frame f with row i's first w bits XORed with the next w keystream
    bits, applied MSB-column-first, for each (i, w) of `rows`."""
    out, k = f.clone(), 0
    for i, w in rows:
        out[:, i, :w] = f[:, i, :w] ^ pr[:, k:k + w].flip(-1).to(torch.int32)
        k += w
    return out


def demodulate_imbe7200x4400_data(frame, device="cuda"):
    """mbe_demodulateImbe7200x4400Data (imbe7200x4400.c:636-673)."""
    f = _tensor(frame, device=device)
    pr = demod.prng_bits(16 * bit_ops.pack_descending(f[:, 0, :], 22, 11), 114).T
    return _xor_keystream(f, pr, ((1, 23), (2, 23), (3, 23), (4, 15), (5, 15), (6, 15)))


def ecc_imbe7200x4400_data(frame, soft_rel=None, device="cuda"):
    """mbe_eccImbe7200x4400Data (imbe7200x4400.c:469-580): data-field ECC +
    88-bit packing. Returns (imbe_d [C, 88], protected_errors, c4_errors)."""
    f, rel = _frame_rel(frame, soft_rel, device)
    dparts = [f[:, 0, 11:23].flip(-1)]
    perrs, c4 = 0, None
    for i in range(1, 4):
        out, errs = _soft_or_hard_golay(f[:, i, :], None if rel is None else rel[:, i, :])
        perrs = perrs + errs
        dparts.append(out[:, 11:23].flip(-1))
    for i in range(4, 7):
        out, errs = _soft_or_hard_hamming(f[:, i, :15], None if rel is None else rel[:, i, :15])
        perrs = perrs + errs
        if i == 4:
            c4 = errs
        dparts.append(out[:, 4:15].flip(-1))
    dparts.append(f[:, 7, :7].flip(-1))
    return torch.cat(dparts, dim=-1), perrs, c4


def ecc_imbe7100x4400_c0(frame, soft_rel=None, device="cuda"):
    """mbe_eccImbe7100x4400C0 (imbe7100x4400.c:99-143): short Golay over 18
    data bits at fr[0][1..18] (padded). Returns (frame', c0_errors)."""
    f, rel = _frame_rel(frame, soft_rel, device)
    pad = torch.zeros((f.shape[0], 5), dtype=torch.int32, device=f.device)
    g_rel = None if rel is None else torch.cat([rel[:, 0, 1:19], pad + 255], dim=-1)
    g_out, errs = _soft_or_hard_golay(torch.cat([f[:, 0, 1:19], pad], dim=-1), g_rel)
    out = f.clone()
    out[:, 0, 1:19] = g_out[:, :18]
    return out, errs


def demodulate_imbe7100x4400_data(frame, device="cuda"):
    """mbe_demodulateImbe7100x4400Data (imbe7100x4400.c:291-334)."""
    f = _tensor(frame, device=device)
    pr = demod.prng_bits(16 * bit_ops.pack_descending(f[:, 0, :], 18, 12), 100).T
    return _xor_keystream(f, pr, ((1, 24), (2, 23), (3, 23), (4, 15), (5, 15)))


def ecc_imbe7100x4400_data(frame, soft_rel=None, device="cuda"):
    """mbe_eccImbe7100x4400Data (imbe7100x4400.c:152-285): data ECC +
    88-bit packing (7100 layout). Returns (imbe_d, protected, c4)."""
    f, rel = _frame_rel(frame, soft_rel, device)
    dparts = [f[:, 0, 12:19].flip(-1)]
    out, perrs = _soft_or_hard_golay(f[:, 1, 1:24], None if rel is None else rel[:, 1, 1:24])
    dparts.append(out[:, 11:23].flip(-1))
    c4 = None
    for i in (2, 3):
        out, errs = _soft_or_hard_golay(f[:, i, :23], None if rel is None else rel[:, i, :23])
        perrs = perrs + errs
        dparts.append(out[:, 11:23].flip(-1))
    for i in (4, 5):
        out, errs = _soft_or_hard_hamming(f[:, i, :15], None if rel is None else rel[:, i, :15],
                                          variant7100=True)
        perrs = perrs + errs
        if i == 4:
            c4 = errs
        dparts.append(out[:, 4:15].flip(-1))
    dparts.append(f[:, 6, :23].flip(-1))
    return torch.cat(dparts, dim=-1), perrs, c4


def _mk_result(c0, prot, c4, soft, c4_valid):
    flags = pipeline.FLAG_C0_VALID
    if soft:
        flags |= pipeline.FLAG_SOFT_INPUT
    if c4_valid:
        flags |= pipeline.FLAG_C4_VALID
    return dict(c0_errors=c0, protected_errors=prot,
                c4_errors=c4 if c4 is not None else torch.zeros_like(c0),
                total_errors=c0 + prot, flags=torch.full_like(c0, flags))


def decode_ambe3600x2450_frame(frame, soft_rel=None, device="cuda"):
    """mbe_decodeAmbe3600x2450[Soft]Frame: (ambe_d [C, 49], result dict)."""
    f, rel = _frame_rel(frame, soft_rel, device)
    d, c0, prot = ambe.decode_ambe3600_frame(f, rel)
    return d.T, _mk_result(c0, prot, None, rel is not None, c4_valid=False)


decode_ambe3600x2400_frame = decode_ambe3600x2450_frame  # same common stage


def decode_imbe7200x4400_frame(frame, soft_rel=None, device="cuda"):
    f, rel = _frame_rel(frame, soft_rel, device)
    d, c0, prot, c4, _ = imbe.decode_imbe7200_frame(f, rel)
    return d.T, _mk_result(c0, prot, c4, rel is not None, c4_valid=True)


def decode_imbe7100x4400_frame(frame, soft_rel=None, device="cuda"):
    f, rel = _frame_rel(frame, soft_rel, device)
    d, c0, prot, c4, _ = imbe.decode_imbe7100_frame(f, rel)
    return d.T, _mk_result(c0, prot, c4, rel is not None, c4_valid=True)


def convert_imbe7100to7200(imbe_d, device="cuda"):
    """mbe_convertImbe7100to7200 over the public [C, 88] layout."""
    return imbe.convert_7100_to_7200(_tensor(imbe_d, device=device).T).T


def decode_imbe4400_parms(imbe_d, st: ChannelState):
    """mbe_decodeImbe4400Parms: returns (state', bad [C]). The port's
    decoder reads the field-forward packed words of imbe_d."""
    words = imbe.pack_imbe_words(_on_state(imbe_d, st).T)
    cur, prev, bad = imbe.decode_imbe4400_parms(words, st.cur, st.prev)
    return dataclasses.replace(st, cur=cur, prev=prev), bad


def decode_ambe2450_parms(ambe_d, st: ChannelState, total_errors=None):
    te = _lanes(-1 if total_errors is None else total_errors, st)
    cur, prev, bad = ambe.decode_ambe2450_parms(_on_state(ambe_d, st).T, st.cur, st.prev, te)
    return dataclasses.replace(st, cur=cur, prev=prev), bad


def decode_ambe2400_parms(ambe_d, st: ChannelState):
    cur, prev, bad = ambe.decode_ambe2400_parms(_on_state(ambe_d, st).T, st.cur, st.prev)
    return dataclasses.replace(st, cur=cur, prev=prev), bad


# --- full process wrappers ---------------------------------------------------

def _process(codec, frame, st, soft_rel, int16, config=DEFAULT_CONFIG):
    # host-side strict 0/1 validation of numpy input, mirroring
    # MBE_STATUS_INVALID_BITS (mbe_result.h:18-42); tensors are covered
    # by the step's per-lane status
    if isinstance(frame, np.ndarray):
        _check_bits(frame)
    if isinstance(soft_rel, np.ndarray):
        if isinstance(frame, np.ndarray) and \
                bit_ops.validate_soft_bits_host(frame) != bit_ops.STATUS_OK:
            raise MbeInvalidBits("soft bits must be 0 or 1")
        # mbe_soft_bit.reliability is uint8 by type (mbelib.h:148-151);
        # reject values this API's int32 arrays could smuggle past that.
        if ((soft_rel < 0) | (soft_rel > 255)).any():
            raise MbeInvalidArgument("soft reliability out of range [0,255]")
    frame = _on_state(frame, st)
    soft_rel = None if soft_rel is None else _on_state(soft_rel, st)
    if int16 or config.int16_output:
        return pipeline.step_int16(codec, frame, st, soft_rel, config)
    return pipeline.step(codec, frame, st, soft_rel, config)


def process_imbe7200x4400_framef(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("imbe7200", frame, st, soft_rel, False, config)


def process_imbe7200x4400_frame(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("imbe7200", frame, st, soft_rel, True, config)


def process_imbe7100x4400_framef(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("imbe7100", frame, st, soft_rel, False, config)


def process_imbe7100x4400_frame(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("imbe7100", frame, st, soft_rel, True, config)


def process_ambe3600x2450_framef(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("ambe2450", frame, st, soft_rel, False, config)


def process_ambe3600x2450_frame(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("ambe2450", frame, st, soft_rel, True, config)


def process_ambe3600x2400_framef(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("ambe2400", frame, st, soft_rel, False, config)


def process_ambe3600x2400_frame(frame, st, soft_rel=None, config=DEFAULT_CONFIG):
    return _process("ambe2400", frame, st, soft_rel, True, config)


def _process_data(codec, d, total_errors, c0_errors, c4_errors, st, config):
    """The Data paths on [C, nbits] parameter bits; c0/c4_errors None =
    context not available. Per-lane MBE_STATUS_INVALID_BITS for tensor
    inputs (numpy inputs were rejected on the host): invalid lanes emit
    silence with their state rolled back, and the decoders run on
    {0,1}-masked bits so they stay total (ambe2450_prepare_process's
    mbe_validate_bits)."""
    c = st.lcg_prime.shape[0]
    zero = torch.zeros((c,), dtype=torch.int32, device=st.lcg_prime.device)
    te = _lanes(total_errors, st)
    c0 = zero if c0_errors is None else _lanes(c0_errors, st)
    c0v = torch.full((c,), c0_errors is not None, device=zero.device)
    d = _on_state(d, st)
    lanes_valid = bit_ops.bits_valid(d)
    d = (d & 1).T  # channel-minor for the internal process paths
    enh_in = st.enh if st.enh is not None else st.cur
    if codec == "imbe":
        c4 = zero if c4_errors is None else _lanes(c4_errors, st)
        c4v = torch.full((c,), c4_errors is not None, device=zero.device)
        out = imbe.process_imbe4400(imbe.pack_imbe_words(d), te, c0, c4, st.cur, st.prev,
                                    enh_in, st.comfort_rng, st.lcg_prime,
                                    c0_valid=c0v, c4_valid=c4v)
    else:
        if st.enh is None:
            raise ValueError("AMBE paths require a carried enh state; "
                             "use init_state(carry_enh=True)")
        process = ambe.process_ambe2450 if codec == "ambe2450" else ambe.process_ambe2400
        out = process(d, te, c0, c0v, st.cur, st.prev, enh_in, st.comfort_rng,
                      st.lcg_prime, tones_enabled=config.tones_enabled)
    audio, cur, prev, enh, rng, lcgp, fsm = out
    if st.enh is None:
        enh = None  # IMBE: enh == cur; keep the carry structure slim
    new_st = ChannelState(cur=cur, prev=prev, enh=enh, comfort_rng=rng, lcg_prime=lcgp)

    def lane_sel(new, old):
        return torch.where(lanes_valid.reshape((1,) * (new.ndim - 1) + (-1,)), new, old)

    new_st = map_state(lane_sel, new_st, st)
    audio = torch.where(lanes_valid[None, :], audio, 0.0).T
    fsm = {k: v & lanes_valid for k, v in fsm.items()}
    fsm["status"] = torch.where(lanes_valid, bit_ops.STATUS_OK,
                                STATUS_INVALID_BITS).to(torch.int32)
    return audio, new_st, fsm


def _resolve_data_entry(total_errors, c0_errors, c4_errors):
    """On-entry result resolution for the Data paths (mbe_result.h:76-114).

    The reference validates/resolves the caller-supplied result before
    processing and refuses inconsistent totals
    (mbe_result_resolve_total_errors called from every mbe_process*Dataf).
    Host (int/numpy/list) inputs get the same treatment here: range
    checks, total==0-with-nonzero-components resolution, and
    total>=component consistency. Where any count is a tensor, total_errors
    passes through unchanged (no host readback), as frame bits do in
    _process.

    Returns the (possibly resolved) total_errors to use.
    """
    if not all(x is None or isinstance(x, (int, np.integer, np.ndarray, list))
               for x in (total_errors, c0_errors, c4_errors)):
        return total_errors
    te = np.atleast_1d(np.asarray(total_errors, np.int64))
    c0 = (np.zeros_like(te) if c0_errors is None
          else np.atleast_1d(np.asarray(c0_errors, np.int64)))
    c4 = (np.zeros_like(te) if c4_errors is None
          else np.atleast_1d(np.asarray(c4_errors, np.int64)))
    for name, arr in (("total", te), ("c0", c0), ("c4", c4)):
        if ((arr < 0) | (arr > 184)).any():
            raise MbeInvalidArgument(f"{name}_errors out of range [0,184]")
    # mbe_result.h:92-95: zero total with nonzero components resolves to the
    # component sum. Component = c0 + protected; this entry point only knows
    # c0 (c4 is a *subset* of protected, never added to the component sum).
    resolved = np.where((te == 0) & (c0 != 0), c0, te)
    if ((resolved < c0) | (resolved < c4)).any():
        raise MbeInvalidArgument("inconsistent totals: total_errors < component errors")
    return np.asarray(resolved, np.int32).reshape(np.shape(total_errors))


def process_imbe4400_dataf(imbe_d, st, total_errors, c0_errors=None,
                           c4_errors=None, config=DEFAULT_CONFIG):
    """mbe_processImbe4400Dataf. c0/c4_errors None = context not available
    (the Dataf fallback repeat rules, imbe7200x4400.c:815-822).
    Returns (audio [C, 160], state', fsm dict of [C]: repeat, mute, status)."""
    if isinstance(imbe_d, np.ndarray):
        _check_bits(imbe_d)  # mbe_validate_bits(imbe_d, 88) on entry
    total_errors = _resolve_data_entry(total_errors, c0_errors, c4_errors)
    return _process_data("imbe", imbe_d, total_errors, c0_errors, c4_errors, st, config)


def process_ambe2450_dataf(ambe_d, st, total_errors, c0_errors=None, config=DEFAULT_CONFIG):
    if isinstance(ambe_d, np.ndarray):
        _check_bits(ambe_d)  # mbe_validate_bits(ambe_d, 49) on entry
    total_errors = _resolve_data_entry(total_errors, c0_errors, None)
    return _process_data("ambe2450", ambe_d, total_errors, c0_errors, None, st, config)


def process_ambe2400_dataf(ambe_d, st, total_errors, c0_errors=None, config=DEFAULT_CONFIG):
    if isinstance(ambe_d, np.ndarray):
        _check_bits(ambe_d)  # mbe_validate_bits(ambe_d, 49) on entry
    total_errors = _resolve_data_entry(total_errors, c0_errors, None)
    return _process_data("ambe2400", ambe_d, total_errors, c0_errors, None, st, config)


# --- debug dumps (host-side, mirror mbe_dump* stderr printers) ---------------

def _bits_str(bits) -> str:
    return "".join(str(int(b)) for b in bits)


def dump_ambe2450_data(ambe_d) -> str:
    """mbe_dumpAmbe2450Data (ambe3600x2450.c:95-107): 49 bits in order."""
    return _bits_str(_host(ambe_d).reshape(-1)[:49])


dump_ambe2400_data = dump_ambe2450_data


def dump_ambe3600_frame(frame) -> str:
    """mbe_dumpAmbe3600x24xxFrame: c0 bits 23..0, c1 22..0, c2 10..0,
    c3 13..0 (ambe3600x2450.c:113-142)."""
    f = _host(frame).reshape(4, 24)
    return " ".join([_bits_str(f[0, 23::-1]), _bits_str(f[1, 22::-1]),
                     _bits_str(f[2, 10::-1]), _bits_str(f[3, 13::-1])])


dump_ambe3600x2450_frame = dump_ambe3600_frame
dump_ambe3600x2400_frame = dump_ambe3600_frame


def dump_imbe4400_data(imbe_d) -> str:
    """mbe_dumpImbe4400Data (imbe7200x4400.c:360-371)."""
    return _bits_str(_host(imbe_d).reshape(-1)[:88])


def _dump_88(imbe_d, gaps) -> str:
    d = _host(imbe_d).reshape(-1)
    return "".join((" " if i in gaps else "") + str(int(d[i])) for i in range(88))


def dump_imbe7200x4400_data(imbe_d) -> str:
    """mbe_dumpImbe7200x4400Data: 88 bits with field separators
    (imbe7200x4400.c:377-391)."""
    return _dump_88(imbe_d, (12, 24, 36, 48, 59, 70, 81))


def dump_imbe7100x4400_data(imbe_d) -> str:
    """mbe_dumpImbe7100x4400Data (imbe7100x4400.c:30-44)."""
    return _dump_88(imbe_d, (7, 19, 31, 43, 54, 65))


def dump_imbe7200x4400_frame(frame) -> str:
    """mbe_dumpImbe7200x4400Frame (imbe7200x4400.c:397-417)."""
    f = _host(frame).reshape(8, 23)
    parts = [_bits_str(f[i, 22::-1]) for i in range(4)]
    parts += [_bits_str(f[i, 14::-1]) for i in range(4, 7)]
    parts += [_bits_str(f[7, 6::-1])]
    return " ".join(parts)


def dump_imbe7100x4400_frame(frame) -> str:
    """mbe_dumpImbe7100x4400Frame (imbe7100x4400.c:50-92)."""
    f = _host(frame).reshape(7, 24)

    def seg(row, hi, gap):
        return "".join((" " if j == gap else "") + str(int(f[row, j]))
                       for j in range(hi, -1, -1))

    parts = [seg(0, 18, 11), seg(1, 23, 11), seg(2, 22, 10), seg(3, 22, 10),
             seg(4, 14, 3), seg(5, 14, 3), _bits_str(f[6, 22::-1])]
    return " ".join(parts)


def resolve_total_errors(result) -> int:
    """mbe_result_resolve_total_errors (mbe_result.h:76-99), host-side.

    Raises MbeInvalidArgument on inconsistent counters; returns the resolved
    total (0 if result is None)."""
    if result is None:
        return 0
    flags = int(result["flags"])
    known = (PROCESS_FLAG_SOFT_INPUT | PROCESS_FLAG_C0_VALID
             | PROCESS_FLAG_C4_VALID | PROCESS_FLAG_TONE
             | PROCESS_FLAG_ERASURE | PROCESS_FLAG_REPEAT | PROCESS_FLAG_MUTE)
    if flags & ~known:
        raise MbeInvalidArgument("unknown flags")
    c0 = int(result["c0_errors"])
    prot = int(result["protected_errors"])
    c4 = int(result["c4_errors"])
    total = int(result["total_errors"])
    for v in (c0, prot, c4, total):
        if not (0 <= v <= 184):
            raise MbeInvalidArgument("error count out of range")
    if c0 > 184 - prot:
        raise MbeInvalidArgument("component overflow")
    component = c0 + prot
    resolved = component if (total == 0 and component != 0) else total
    consistent = ((component == 0 or resolved == component)
                  and (not flags & PROCESS_FLAG_C0_VALID or resolved >= c0)
                  and (not flags & PROCESS_FLAG_C4_VALID or resolved >= c4))
    if not consistent:
        raise MbeInvalidArgument("inconsistent totals")
    return resolved


# --- explicit Soft/short variant names (1:1 with the reference header) -------

def _soft_f(codec):
    def fn(frame, soft_rel, st, config=DEFAULT_CONFIG):
        return _process(codec, frame, st, soft_rel, False, config)
    return fn


def _soft_s(codec):
    def fn(frame, soft_rel, st, config=DEFAULT_CONFIG):
        return _process(codec, frame, st, soft_rel, True, config)
    return fn


process_imbe7200x4400_soft_framef = _soft_f("imbe7200")
process_imbe7200x4400_soft_frame = _soft_s("imbe7200")
process_imbe7100x4400_soft_framef = _soft_f("imbe7100")
process_imbe7100x4400_soft_frame = _soft_s("imbe7100")
process_ambe3600x2450_soft_framef = _soft_f("ambe2450")
process_ambe3600x2450_soft_frame = _soft_s("ambe2450")
process_ambe3600x2400_soft_framef = _soft_f("ambe2400")
process_ambe3600x2400_soft_frame = _soft_s("ambe2400")


def decode_imbe7200x4400_soft_frame(frame, soft_rel, device="cuda"):
    return decode_imbe7200x4400_frame(frame, soft_rel, device)


def decode_imbe7100x4400_soft_frame(frame, soft_rel, device="cuda"):
    return decode_imbe7100x4400_frame(frame, soft_rel, device)


def decode_ambe3600x2450_soft_frame(frame, soft_rel, device="cuda"):
    return decode_ambe3600x2450_frame(frame, soft_rel, device)


def decode_ambe3600x2400_soft_frame(frame, soft_rel, device="cuda"):
    return decode_ambe3600x2400_frame(frame, soft_rel, device)


def _data_int16(fn):
    def wrapper(*args, **kw):
        audio, st2, fsm = fn(*args, **kw)
        return synth_ops.float_to_short(audio), st2, fsm
    return wrapper


process_imbe4400_data = _data_int16(process_imbe4400_dataf)
process_ambe2450_data = _data_int16(process_ambe2450_dataf)
process_ambe2400_data = _data_int16(process_ambe2400_dataf)


#: 1:1 map from every reference public symbol (include/mbelib-neo/mbelib.h)
#: to its counterpart here, with mbe_tpu.api's keys. Checked exhaustively by
#: tests/test_torch_api.py.
REFERENCE_SYMBOL_MAP = {
    "mbe_versionString": "mbe_tpu_torch.version_string",
    "mbe_initProcessResult": "init_process_result",
    "mbe_formatProcessResult": "format_process_result",
    "mbe_softBitFromHard": "soft_bit_from_hard",
    "mbe_softBitFromLlr": "soft_bit_from_llr",
    "mbe_softBitsFromHard": "soft_bits_from_hard",
    "mbe_softBitsFromLlr": "soft_bits_from_llr",
    "mbe_checkGolayBlock": "check_golay_block",
    "mbe_golay2312": "golay2312",
    "mbe_golay2312Soft": "golay2312_soft",
    "mbe_hamming1511": "hamming1511",
    "mbe_hamming1511Soft": "hamming1511_soft",
    "mbe_7100x4400hamming1511": "hamming1511_7100x4400",
    "mbe_7100x4400hamming1511Soft": "hamming1511_7100x4400_soft",
    "mbe_initMbeParms": "init_mbe_parms",
    "mbe_setThreadRngSeed": "set_rng_seed",
    "mbe_moveMbeParms": "move_mbe_parms",
    "mbe_useLastMbeParms": "use_last_mbe_parms",
    "mbe_spectralAmpEnhance": "spectral_amp_enhance_parms",
    "mbe_applyAdaptiveSmoothing": "apply_adaptive_smoothing",
    "mbe_requiresAdaptiveSmoothing": "requires_adaptive_smoothing",
    "mbe_requiresMuting": "requires_muting",
    "mbe_isMaxFrameRepeat": "is_max_frame_repeat",
    "mbe_synthesizeComfortNoisef": "synthesize_comfort_noisef",
    "mbe_synthesizeComfortNoise": "synthesize_comfort_noise",
    "mbe_synthesizeSilencef": "synthesize_silencef",
    "mbe_synthesizeSilence": "synthesize_silence",
    "mbe_synthesizeSpeechf": "synthesize_speechf",
    "mbe_synthesizeSpeech": "synthesize_speech",
    "mbe_synthesizeTonef": "synthesize_tonef",
    "mbe_synthesizeTonefdstar": "synthesize_tonef_dstar",
    "mbe_floattoshort": "float_to_short",
    "mbe_convertImbe7100to7200": "convert_imbe7100to7200",
    # per-codec stage functions
    "mbe_eccAmbe3600x2450C0": "ecc_ambe3600x2450_c0",
    "mbe_eccAmbe3600x2400C0": "ecc_ambe3600x2400_c0",
    "mbe_eccAmbe3600x2450Data": "ecc_ambe3600x2450_data",
    "mbe_eccAmbe3600x2400Data": "ecc_ambe3600x2400_data",
    "mbe_eccImbe7200x4400C0": "ecc_imbe7200x4400_c0",
    "mbe_eccImbe7200x4400Data": "ecc_imbe7200x4400_data",
    "mbe_eccImbe7100x4400C0": "ecc_imbe7100x4400_c0",
    "mbe_eccImbe7100x4400Data": "ecc_imbe7100x4400_data",
    "mbe_demodulateAmbe3600x2450Data": "demodulate_ambe3600x2450_data",
    "mbe_demodulateAmbe3600x2400Data": "demodulate_ambe3600x2400_data",
    "mbe_demodulateImbe7200x4400Data": "demodulate_imbe7200x4400_data",
    "mbe_demodulateImbe7100x4400Data": "demodulate_imbe7100x4400_data",
    "mbe_decodeAmbe2450Parms": "decode_ambe2450_parms",
    "mbe_decodeAmbe2400Parms": "decode_ambe2400_parms",
    "mbe_decodeImbe4400Parms": "decode_imbe4400_parms",
    "mbe_decodeAmbe3600x2450Frame": "decode_ambe3600x2450_frame",
    "mbe_decodeAmbe3600x2450SoftFrame": "decode_ambe3600x2450_soft_frame",
    "mbe_decodeAmbe3600x2400Frame": "decode_ambe3600x2400_frame",
    "mbe_decodeAmbe3600x2400SoftFrame": "decode_ambe3600x2400_soft_frame",
    "mbe_decodeImbe7200x4400Frame": "decode_imbe7200x4400_frame",
    "mbe_decodeImbe7200x4400SoftFrame": "decode_imbe7200x4400_soft_frame",
    "mbe_decodeImbe7100x4400Frame": "decode_imbe7100x4400_frame",
    "mbe_decodeImbe7100x4400SoftFrame": "decode_imbe7100x4400_soft_frame",
    "mbe_processAmbe2450Dataf": "process_ambe2450_dataf",
    "mbe_processAmbe2450Data": "process_ambe2450_data",
    "mbe_processAmbe2400Dataf": "process_ambe2400_dataf",
    "mbe_processAmbe2400Data": "process_ambe2400_data",
    "mbe_processImbe4400Dataf": "process_imbe4400_dataf",
    "mbe_processImbe4400Data": "process_imbe4400_data",
    "mbe_processAmbe3600x2450Framef": "process_ambe3600x2450_framef",
    "mbe_processAmbe3600x2450Frame": "process_ambe3600x2450_frame",
    "mbe_processAmbe3600x2450SoftFramef": "process_ambe3600x2450_soft_framef",
    "mbe_processAmbe3600x2450SoftFrame": "process_ambe3600x2450_soft_frame",
    "mbe_processAmbe3600x2400Framef": "process_ambe3600x2400_framef",
    "mbe_processAmbe3600x2400Frame": "process_ambe3600x2400_frame",
    "mbe_processAmbe3600x2400SoftFramef": "process_ambe3600x2400_soft_framef",
    "mbe_processAmbe3600x2400SoftFrame": "process_ambe3600x2400_soft_frame",
    "mbe_processImbe7200x4400Framef": "process_imbe7200x4400_framef",
    "mbe_processImbe7200x4400Frame": "process_imbe7200x4400_frame",
    "mbe_processImbe7200x4400SoftFramef": "process_imbe7200x4400_soft_framef",
    "mbe_processImbe7200x4400SoftFrame": "process_imbe7200x4400_soft_frame",
    "mbe_processImbe7100x4400Framef": "process_imbe7100x4400_framef",
    "mbe_processImbe7100x4400Frame": "process_imbe7100x4400_frame",
    "mbe_processImbe7100x4400SoftFramef": "process_imbe7100x4400_soft_framef",
    "mbe_processImbe7100x4400SoftFrame": "process_imbe7100x4400_soft_frame",
    "mbe_dumpAmbe2450Data": "dump_ambe2450_data",
    "mbe_dumpAmbe2400Data": "dump_ambe2400_data",
    "mbe_dumpAmbe3600x2450Frame": "dump_ambe3600x2450_frame",
    "mbe_dumpAmbe3600x2400Frame": "dump_ambe3600x2400_frame",
    "mbe_dumpImbe4400Data": "dump_imbe4400_data",
    "mbe_dumpImbe7200x4400Data": "dump_imbe7200x4400_data",
    "mbe_dumpImbe7100x4400Data": "dump_imbe7100x4400_data",
    "mbe_dumpImbe7200x4400Frame": "dump_imbe7200x4400_frame",
    "mbe_dumpImbe7100x4400Frame": "dump_imbe7100x4400_frame",
}
