"""Per-frame decode + synthesis step and the time loop (port of
mbe_tpu.pipeline, hard IMBE 7200x4400).

`step` takes a batch of frames ([C, 8, 23] bit planes) plus the channel
state and returns (state', pcm [C, 160], result, imbe_d [C, 88]); the
device is the one the frames and state live on. Throughput comes from
the channel axis; `run_sequence` loops over time.
"""

import torch

from .models import imbe
from .models.state import ChannelState, map_state
from .ops import bits as bit_ops
from .ops import synth as synth_ops
from .utils.config import DEFAULT as DEFAULT_CONFIG, DecoderConfig

STATUS_OK = 0
STATUS_INVALID_BITS = -2

FLAG_SOFT_INPUT = 0x0001
FLAG_C0_VALID = 0x0002
FLAG_C4_VALID = 0x0004
FLAG_TONE = 0x0010
FLAG_ERASURE = 0x0020
FLAG_REPEAT = 0x0040
FLAG_MUTE = 0x0080

CODECS = ("imbe7200", "imbe7100", "ambe2450", "ambe2400")

# what of mbe_tpu.pipeline is not ported yet, by ROADMAP item
_NOT_PORTED = {
    "imbe7100": "IMBE 7100x4400 (ROADMAP A7)",
    "ambe2450": "AMBE+2 3600x2450 (ROADMAP A8)",
    "ambe2400": "AMBE 3600x2400 (ROADMAP A8)",
}


def _pack_flags(base, fsm):
    flags = torch.full_like(fsm["repeat"], base, dtype=torch.int32)
    flags = flags | torch.where(fsm["repeat"], FLAG_REPEAT, 0).to(torch.int32)
    return flags | torch.where(fsm["mute"], FLAG_MUTE, 0).to(torch.int32)


def step(codec: str, frame, state: ChannelState, soft_rel=None,
         config: DecoderConfig = DEFAULT_CONFIG):
    """Full decode + process for one 20 ms frame across all channels.

    Args:
      codec: "imbe7200" (the other CODECS are not ported yet).
      frame: [C, 8, 23] integer bit planes.
      state: ChannelState on the frame's device.
      soft_rel: must be None (the soft path is not ported yet).
      config: DecoderConfig.
    Returns:
      (state', audio [C, 160] f32, result dict of [C] int32 arrays,
      imbe_d [C, 88] int32). Invalid lanes (bits outside {0, 1}) emit
      silence, keep their state and report status -2 when
      config.validate_lanes (mbe_result.h:18-42).
    """
    if codec in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[codec]} is not ported yet")
    if codec != "imbe7200":
        raise ValueError(f"unknown codec {codec!r}")
    if soft_rel is not None:
        raise NotImplementedError("soft-decision input (ROADMAP A9) is not ported yet")

    if config.validate_lanes:
        lanes_valid = bit_ops.bits_valid(frame)
        frame = frame & 1
    else:
        lanes_valid = None

    d, c0, prot, c4, words = imbe.decode_imbe7200_frame(frame)
    total = c0 + prot

    # IMBE-only streams may carry no enh: enh == cur at every IMBE step
    # boundary (imbe7200x4400.c:856), so the incoming cur stands in for it
    enh_in = state.enh if state.enh is not None else state.cur
    audio, cur, prev, enh, rng, lcgp, fsm = imbe.process_imbe4400(
        words, total, c0, c4, state.cur, state.prev, enh_in,
        state.comfort_rng, state.lcg_prime)
    new_state = ChannelState(cur=cur, prev=prev,
                             enh=None if state.enh is None else enh,
                             comfort_rng=rng, lcg_prime=lcgp)

    res = dict(c0_errors=c0, protected_errors=prot, c4_errors=c4,
               total_errors=total,
               flags=_pack_flags(FLAG_C0_VALID | FLAG_C4_VALID, fsm))
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


def run_sequence(codec: str, frames, state: ChannelState, soft_rel=None,
                 int16=False, config: DecoderConfig = DEFAULT_CONFIG):
    """Run a [T, C, rows, cols] frame sequence through the decoder.

    Returns (state', pcm [T, C, 160], results dict of [T, C] arrays).
    """
    int16 = int16 or config.int16_output
    pcm, results = [], []
    for t in range(frames.shape[0]):
        state, audio, res, _ = step(
            codec, frames[t], state,
            None if soft_rel is None else soft_rel[t], config)
        pcm.append(synth_ops.float_to_short(audio) if int16 else audio)
        results.append(res)
    return (state, torch.stack(pcm),
            {k: torch.stack([r[k] for r in results]) for k in results[0]})
