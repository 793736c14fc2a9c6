"""Per-frame decode + synthesis step and the time loop (port of
mbe_tpu.pipeline: IMBE 7200x4400 and 7100x4400, AMBE+2 3600x2450 and
AMBE 3600x2400, hard and soft input).

`step` takes a batch of frames ([C, rows, cols] bit planes) plus the channel
state and returns (state', pcm [C, 160], result, parameter bits [C, nbits]);
the device is the one the frames and state live on. Throughput comes from
the channel axis; `run_sequence` loops over time.

`CompiledStep` is the port of `jax.jit(step, donate_argnums=state)`: on the
card, one step captured into a CUDA graph over static input and state
buffers that each replay updates in place. `run_sequence` replays it once
per frame (the counterpart of the reference's jitted `lax.scan`).
"""

import collections

import torch

from .models import ambe, imbe
from .models.state import ChannelState, map_state
from .utils import graphs
from .ops import bits as bit_ops
from .ops import synth as synth_ops
from .ops.cuda import marks
from .ops.bits import STATUS_INVALID_BITS, STATUS_OK  # noqa: F401  (the result's status)
from .utils.config import DEFAULT as DEFAULT_CONFIG, DecoderConfig

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

    On the card the step's device work carries region marks
    (ops/cuda/marks.py): bit_domain here, fsm and synthesis in the
    process functions, commit once they return.
    """
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    is_ambe = codec.startswith("ambe")
    if is_ambe and state.enh is None:
        raise ValueError("AMBE steps need a carried enh state; "
                         "use init_state(carry_enh=True)")
    soft = soft_rel is not None
    marks.mark("bit_domain", frame)

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
    marks.mark("commit", frame)
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


class CompiledStep:
    """One `step` over static buffers: the port of `jax.jit(step,
    donate_argnums=state)`.

    CompiledStep(codec, state, soft, int16, config) takes ownership of
    `state` (donation): its tensors become the static state, which every
    call updates in place, and the caller does not use the object it
    passed again. The static inputs are `frame` [C, rows, cols] int32 and,
    when `soft`, `soft_rel` [C, rows, cols] int32.

    A call `compiled(frame, soft_rel=None)` copies the frame (any integer
    dtype: `copy_` converts) into the static input, runs the step and
    returns (state, audio [C, 160], result dict of [C] int32): `state` is
    the static state itself, and audio, the result words and `dbits` (the
    parameter bits [C, nbits]) are static outputs that the next call
    overwrites. A caller that keeps them copies them, as `run_sequence`
    does. With `int16`, audio is float_to_short's.

    On a CUDA state the step is captured once into a CUDA graph
    (utils/graphs.py) after one eager warm-up step on a copy of the state,
    and each call replays it. A failed capture raises. On a CPU state the
    same body runs eagerly on the same static buffers.
    """

    def __init__(self, codec: str, state: ChannelState, soft: bool = False, int16: bool = False,
                 config: DecoderConfig = DEFAULT_CONFIG):
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}")
        if codec.startswith("ambe") and state.enh is None:
            raise ValueError("AMBE steps need a carried enh state; "
                             "use init_state(carry_enh=True)")
        self.codec, self.soft, self.int16, self.config = codec, soft, int16, config
        self.state = state
        self.device = state.lcg_prime.device
        shape = (state.lcg_prime.shape[0], *FRAME_SHAPES[codec])
        self.frame = torch.zeros(shape, dtype=torch.int32, device=self.device)
        self.soft_rel = (torch.zeros(shape, dtype=torch.int32, device=self.device)
                         if soft else None)
        self._graph = None
        if self.device.type == "cuda":
            self._graph = graphs.Captured(
                lambda: self._body(self.state), self.device,
                warmup=lambda: self._body(map_state(torch.clone, self.state)))
            self._out = self._graph.outputs

    def _body(self, state):
        """step on the static inputs, its new state copied into `state`:
        (audio, result words [C, n] int32 in `res` key order, dict of
        their columns, dbits)."""
        new_state, audio, res, d = step(self.codec, self.frame, state, self.soft_rel,
                                        self.config)
        if self.int16:
            audio = synth_ops.float_to_short(audio)
        graphs.copy_into(graphs.leaves(state), graphs.leaves(new_state))
        words = torch.stack([v.to(torch.int32) for v in res.values()], dim=1)
        marks.mark("end", words)
        return audio, words, {k: words[:, i] for i, k in enumerate(res)}, d

    def __call__(self, frame, soft_rel=None):
        if (soft_rel is not None) != self.soft:
            raise ValueError(f"this CompiledStep was built with soft={self.soft}")
        for name, x in (("frame", frame), ("soft_rel", soft_rel)):
            if x is not None and tuple(x.shape) != tuple(self.frame.shape):
                raise ValueError(f"{name} must be {tuple(self.frame.shape)}, "
                                 f"got {tuple(x.shape)}")
        self.frame.copy_(frame)
        if self.soft:
            self.soft_rel.copy_(soft_rel)
        if self._graph is None:
            self._out = self._body(self.state)
        else:
            self._graph.replay()
        audio, _, res, _ = self._out
        return self.state, audio, res

    @property
    def words(self):
        """The last call's result words [C, n] int32, columns in the
        result dict's key order (static)."""
        return self._out[1]

    @property
    def dbits(self):
        """The last call's parameter bits [C, nbits] int32 (static)."""
        return self._out[3]


_COMPILED = collections.OrderedDict()
_COMPILED_MAX = 4  # compiled steps kept for run_sequence, least recently used dropped


def compiled_step(codec: str, state: ChannelState, soft: bool = False, int16: bool = False,
                  config: DecoderConfig = DEFAULT_CONFIG) -> CompiledStep:
    """The cached CompiledStep of (codec, soft, int16, C, config, device,
    carry_enh), with `state` copied into its static state (the caller's
    state is not donated). At most _COMPILED_MAX are kept."""
    key = (codec, soft, int16, state.lcg_prime.shape[0], config, state.lcg_prime.device,
           state.enh is not None)
    compiled = _COMPILED.pop(key, None)
    if compiled is None:
        while len(_COMPILED) >= _COMPILED_MAX:
            _COMPILED.popitem(last=False)
        compiled = CompiledStep(codec, map_state(torch.clone, state), soft, int16, config)
    else:
        graphs.copy_into(graphs.leaves(compiled.state), graphs.leaves(state))
    _COMPILED[key] = compiled
    return compiled


def clear_compiled():
    """Drop every cached compiled step, and with it its graph's memory."""
    _COMPILED.clear()


def replay_sequence(compiled: CompiledStep, frames, soft_rel=None):
    """compiled over frames [T, C, rows, cols] (and soft_rel [T, C, rows,
    cols]) from its current state: (pcm [T, C, 160], results dict of
    [T, C] int32). Per frame: the frame copied in, one replay, the PCM and
    the result words copied out."""
    T = frames.shape[0]
    c = compiled.frame.shape[0]
    pcm = torch.empty((T, c, 160), dtype=torch.int16 if compiled.int16 else torch.float32,
                      device=compiled.device)
    words, keys = None, None
    for t in range(T):
        _, audio, res = compiled(frames[t], None if soft_rel is None else soft_rel[t])
        if words is None:
            keys = tuple(res)
            words = torch.empty((T, *compiled.words.shape), dtype=torch.int32,
                                device=compiled.device)
        pcm[t].copy_(audio)
        words[t].copy_(compiled.words)
    return pcm, {k: words[:, :, i].contiguous() for i, k in enumerate(keys)}


def run_sequence(codec: str, frames, state: ChannelState, soft_rel=None,
                 int16=False, config: DecoderConfig = DEFAULT_CONFIG):
    """Run a [T, C, rows, cols] frame sequence through the decoder.

    Replays the compiled step (compiled_step: `state` is copied in, not
    donated) once per frame. Returns (state', pcm [T, C, 160], results
    dict of [T, C] arrays); state' is a copy that no later call touches.
    """
    int16 = int16 or config.int16_output
    compiled = compiled_step(codec, state, soft_rel is not None, int16, config)
    pcm, results = replay_sequence(compiled, frames, soft_rel)
    return map_state(torch.clone, compiled.state), pcm, results
