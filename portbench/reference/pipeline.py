"""Per-frame decode + synthesis step (IMBE 7200x4400 and 7100x4400, AMBE+2
3600x2450 and AMBE 3600x2400, hard and soft input), eager and plain.

`step` takes a batch of frames ([C, rows, cols] bit planes) plus the channel
state and returns (state', pcm [C, 160], result, parameter bits [C, nbits]);
the device is the one the frames and state live on.
"""

import torch

from .models import ambe, imbe
from .models.state import ChannelState, map_state
from .ops import bits as bit_ops
from .ops import synth as synth_ops
from .ops.bits import STATUS_INVALID_BITS, STATUS_OK  # noqa: F401  (the result's status)
from .config import DEFAULT as DEFAULT_CONFIG, DecoderConfig

FLAG_SOFT_INPUT = 0x0001
FLAG_C0_VALID = 0x0002
FLAG_C4_VALID = 0x0004
FLAG_TONE = 0x0010
FLAG_ERASURE = 0x0020
FLAG_REPEAT = 0x0040
FLAG_MUTE = 0x0080

CODECS = ("imbe7200", "imbe7100", "ambe2450", "ambe2400")
FRAME_SHAPES = {
    "imbe7200": (8, 23),
    "imbe7100": (7, 24),
    "ambe2450": (4, 24),
    "ambe2400": (4, 24),
}
DBITS = {"imbe7200": 88, "imbe7100": 88, "ambe2450": 49, "ambe2400": 49}


def _pack_flags(base, fsm):
    flags = torch.full_like(fsm["repeat"], base, dtype=torch.int32)
    for name, bit in (("erasure", FLAG_ERASURE), ("tone", FLAG_TONE),
                      ("repeat", FLAG_REPEAT), ("mute", FLAG_MUTE)):
        if name in fsm:
            flags = flags | torch.where(fsm[name], bit, 0).to(torch.int32)
    return flags


def step(codec: str, frame, state: ChannelState, soft_rel=None,
         config: DecoderConfig = DEFAULT_CONFIG):
    """Full decode + process for one 20 ms frame across all channels.

    Args:
      codec: one of CODECS.
      frame: [C, rows, cols] integer bit planes (hard bits or the hard
        decisions of soft input): [C, 8, 23] for imbe7200, [C, 7, 24]
        for imbe7100, [C, 4, 24] for ambe2450 and ambe2400.
      state: ChannelState on the frame's device; the AMBE codecs need its
        enh copy (init_state(carry_enh=True)).
      soft_rel: [C, rows, cols] integer reliabilities for the soft path,
        or None.
      config: DecoderConfig; tones_enabled=False renders AMBE tone frames
        as silence with the tone state kept (DISABLE_AMBE_TONES,
        mbelib.c:747-751).
    Returns:
      (state', audio [C, 160] f32, result dict of [C] int32 arrays,
      parameter bits [C, 88] int32 imbe_d or [C, 49] ambe_d). Invalid lanes
      (bits outside {0, 1}) emit silence, keep their state and report
      status -2 when config.validate_lanes (mbe_result.h:18-42);
      reliabilities are then clamped to the uint8 range the C type
      enforces.
    """
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    is_ambe = codec.startswith("ambe")
    if is_ambe and state.enh is None:
        raise ValueError("AMBE steps need a carried enh state; "
                         "use init_state(carry_enh=True)")
    soft = soft_rel is not None

    if config.validate_lanes:
        lanes_valid = bit_ops.bits_valid(frame)
        frame = frame & 1
        if soft:
            soft_rel = torch.clamp(soft_rel.to(torch.int32), 0, 255)
    else:
        lanes_valid = None

    base = (FLAG_SOFT_INPUT if soft else 0) | FLAG_C0_VALID
    if is_ambe:
        d, c0, prot = ambe.decode_ambe3600_frame(frame, soft_rel)
        c4 = torch.zeros_like(c0)
        total = c0 + prot
        process = ambe.process_ambe2450 if codec == "ambe2450" else ambe.process_ambe2400
        audio, cur, prev, enh, rng, lcgp, fsm = process(
            d, total, c0, torch.ones_like(c0, dtype=torch.bool), state.cur, state.prev,
            state.enh, state.comfort_rng, state.lcg_prime, tones_enabled=config.tones_enabled)
    else:
        decode = (imbe.decode_imbe7200_frame if codec == "imbe7200"
                  else imbe.decode_imbe7100_frame)
        d, c0, prot, c4, words = decode(frame, soft_rel)
        total = c0 + prot
        # IMBE-only streams may carry no enh: enh == cur at every IMBE step
        # boundary (imbe7200x4400.c:856), so the incoming cur stands in for it
        enh_in = state.enh if state.enh is not None else state.cur
        audio, cur, prev, enh, rng, lcgp, fsm = imbe.process_imbe4400(
            words, total, c0, c4, state.cur, state.prev, enh_in,
            state.comfort_rng, state.lcg_prime)
        if state.enh is None:
            enh = None
        base |= FLAG_C4_VALID
    new_state = ChannelState(cur=cur, prev=prev, enh=enh, comfort_rng=rng, lcg_prime=lcgp)

    res = dict(c0_errors=c0, protected_errors=prot, c4_errors=c4,
               total_errors=total, flags=_pack_flags(base, fsm))
    if lanes_valid is None:
        res["status"] = torch.zeros_like(c0)
        return new_state, audio.T, res, d.T

    # invalid lanes: silence, state rolled back, zeroed counts (the C
    # returns MBE_STATUS_INVALID_BITS before touching anything)
    def lane_sel(new, old):
        return torch.where(lanes_valid.reshape((1,) * (new.ndim - 1) + (-1,)), new, old)

    new_state = map_state(lane_sel, new_state, state)
    audio = torch.where(lanes_valid[None, :], audio, 0.0)
    res = {k: torch.where(lanes_valid, v, 0) for k, v in res.items()}
    res["status"] = torch.where(lanes_valid, STATUS_OK, STATUS_INVALID_BITS).to(torch.int32)
    d = torch.where(lanes_valid[None, :], d, 0)
    return new_state, audio.T, res, d.T


def step_int16(codec: str, frame, state: ChannelState, soft_rel=None,
               config: DecoderConfig = DEFAULT_CONFIG):
    """step() + float->int16 conversion (the `short` API variants)."""
    new_state, audio, res, d = step(codec, frame, state, soft_rel, config)
    return new_state, synth_ops.float_to_short(audio), res, d
