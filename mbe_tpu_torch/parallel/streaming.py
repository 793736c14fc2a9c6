"""Host <-> device streaming loop for continuous decode (port of
mbe_tpu.parallel.streaming).

Per 20 ms tick, each channel needs <= 24 bytes of frame bits in and 320
bytes of PCM out. Packed uint8 frames go to the device as bytes and are
expanded to bit planes there (int32 bit planes would be 32x the
host-to-device bytes); `unpack="host"` expands them on the host instead.

On a GPU a tick is one CUDA graph (the port of the reference's
`jax.jit(_step_packed, donate_argnums=(1,))`): the device unpack from a
static [C, S] uint8 input (or the static int32 bit planes of host-unpack
mode), the step over the static state, updated in place, float_to_short
and the bundle, into a static bundle tensor. A tick is four operations on
one stream: a non-blocking copy from a pinned host buffer into the static
input, the replay, a non-blocking copy of the bundle into another pinned
buffer, and a CUDA event. The copy out of tick t is queued before the
replay of tick t + 1 overwrites the bundle. The host waits on a tick's
event only when it yields that tick, `depth` ticks later. The pinned
buffers rotate over depth + 1 slots: a slot is written again only after
the tick that last used it has been read back (its input copy and its
step come before its readback on the one stream).

The host phases of a tick are spans (utils/spans.py): `mbe.stream.stage`
(host unpack, the pinned copy and the upload's enqueue), the replay's
`mbe.graph.replay`, and at readback `mbe.stream.wait` and
`mbe.stream.copy_out`. The tick's graph carries the step's region marks
(ops/cuda/marks.py), from bit_domain before the unpack to end after the
bundle.
"""

import collections

import numpy as np
import torch

from .. import native, pipeline
from ..models import state as state_mod
from ..ops import synth as synth_ops
from ..ops.cuda import marks
from ..utils import graphs
from ..utils.spans import span

# Fixed key order for the bundled result block (see _bundle below).
_RES_KEYS = ("c0_errors", "protected_errors", "c4_errors", "total_errors", "flags")


def _bundle(audio, res):
    """The PCM block [C, 160] and the five per-channel int32 result arrays
    as ONE tensor, so the host pulls a single transfer per tick: the result
    words are reinterpreted in the PCM dtype (Tensor.view) and appended as
    extra columns. `_unbundle` reverses this without loss."""
    c = audio.shape[0]
    resw = torch.stack([res[k].to(torch.int32) for k in _RES_KEYS], dim=1)
    return torch.cat([audio, resw.view(audio.dtype).reshape(c, -1)], dim=1)


def _unbundle(buf: np.ndarray, n_samples: int = 160):
    """Host-side inverse of `_bundle`: -> (audio [C, 160], res dict)."""
    audio = buf[:, :n_samples]
    resw = np.ascontiguousarray(buf[:, n_samples:]).view(np.int32)
    return audio, {k: resw[:, i] for i, k in enumerate(_RES_KEYS)}


def unpack_bits_device(packed, n_bits: int):
    """[C, S] uint8 packed MSB-first -> [C, n_bits] int32 0/1 on the
    packed tensor's device (np.unpackbits order: bit i of the stream is
    bit 7 - i % 8 of byte i // 8)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_bits]


class StreamingDecoder:
    """Continuous batched decoder with an asynchronous in-flight window.

    Usage:
        dec = StreamingDecoder("ambe2450", channels=1024)
        for packed in frame_source:          # [C, bytes] uint8 per 20 ms
            for pcm, res in dec.push(packed):  # completed [C, 160] int16
                sink(pcm)
        for pcm, res in dec.flush():
            sink(pcm)

    `unpack="device"` (default) uploads packed bytes and unpacks them on
    the device; `unpack="host"` expands them with `native.unpack_bits`
    first. The state lives on `device` (the GPU by default; without one
    that raises, as init_state does).
    """

    def __init__(self, codec: str, channels: int, rng_seed=None, depth: int = 2,
                 int16: bool = True, unpack: str = "device", device="cuda"):
        if codec not in pipeline.CODECS:
            raise ValueError(f"unknown codec {codec!r}")
        if unpack not in ("device", "host"):
            raise ValueError(f"unpack must be 'device' or 'host', not {unpack!r}")
        self.codec = codec
        self.channels = channels
        self.rows, self.cols = pipeline.FRAME_SHAPES[codec]
        self.n_bits = self.rows * self.cols
        self._state = state_mod.init_state(channels, rng_seed, device=device)
        self._device = self._state.lcg_prime.device
        self._cuda = self._device.type == "cuda"
        self._int16 = int16
        self._unpack_mode = unpack
        self._depth = depth
        self._slots = [dict(inp=None, out=None) for _ in range(depth + 1)]
        self._tick = 0
        self._inflight = collections.deque()
        self._graphs = {}  # (input shape, dtype) -> [static input, Captured]

    @staticmethod
    def _pinned(buf, like):
        """`buf` if it is a pinned tensor of like's shape and dtype, else a
        new one."""
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return buf

    def _body(self, inp, state):
        """One tick on the device: the frame from `inp` ([C, S] uint8 packed
        bytes, unpacked here, or [C, rows, cols] int32 bit planes), the step
        with its new state copied into `state`, and the bundle."""
        marks.mark("bit_domain", inp)
        frame = (unpack_bits_device(inp, self.n_bits).reshape(self.channels, self.rows, self.cols)
                 if inp.dtype == torch.uint8 else inp)
        new_state, audio, res, _ = pipeline.step(self.codec, frame, state)
        graphs.copy_into(graphs.leaves(state), graphs.leaves(new_state))
        if self._int16:
            audio = synth_ops.float_to_short(audio)
        out = _bundle(audio, res)
        marks.mark("end", out)
        return out

    def _entry(self, host):
        """[static input, captured tick] for inputs like `host`: the static
        input made at their first use, the tick captured by `_captured`."""
        key = (tuple(host.shape), host.dtype)
        if key not in self._graphs:
            self._graphs[key] = [torch.zeros(host.shape, dtype=host.dtype, device=self._device),
                                 None]
        return self._graphs[key]

    def _captured(self, entry):
        """The tick over entry's static input, captured at its first replay
        (after the upload, outside the stage span, which it would swamp)."""
        if entry[1] is None:
            inp = entry[0]
            entry[1] = graphs.Captured(
                lambda: self._body(inp, self._state), self._device,
                warmup=lambda: self._body(inp, state_mod.map_state(torch.clone, self._state)))
        return entry[1]

    def _launch(self, packed_frames):
        """Queue one tick: upload, replay (unpack, step, bundle) and start
        the readback."""
        slot = self._slots[self._tick % len(self._slots)]
        self._tick += 1
        with span("mbe.stream.stage"):
            arr = np.asarray(packed_frames)
            if arr.dtype == np.uint8 and arr.ndim == 2 and self._unpack_mode == "host":
                arr = native.unpack_bits(arr.reshape(self.channels, -1), self.n_bits)
            if not (arr.dtype == np.uint8 and arr.ndim == 2):
                arr = np.asarray(arr, np.int32).reshape(self.channels, self.rows, self.cols)
            host = torch.from_numpy(np.ascontiguousarray(arr))
            if self._cuda:
                entry = self._entry(host)
                slot["inp"] = self._pinned(slot["inp"], host)
                slot["inp"].copy_(host)
                entry[0].copy_(slot["inp"], non_blocking=True)
        if not self._cuda:
            self._inflight.append((None, self._body(host.to(self._device), self._state)))
            return
        graph = self._captured(entry)
        graph.replay()
        slot["out"] = self._pinned(slot["out"], graph.outputs)
        slot["out"].copy_(graph.outputs, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._device))
        self._inflight.append((done, slot["out"]))

    def _collect(self):
        done, buf = self._inflight.popleft()
        with span("mbe.stream.wait"):
            if done is not None:
                done.synchronize()
        with span("mbe.stream.copy_out"):
            return _unbundle(buf.numpy().copy())

    def push(self, packed_frames):
        """Feed one 20 ms frame for every channel ([C, bytes] uint8 or
        [C, rows, cols] 0/1 int). Yields completed (pcm [C, 160], result
        dict of [C] int32) pairs, none while the window fills."""
        self._launch(packed_frames)
        # read back before yielding, so the window never exceeds depth
        # ticks (and no slot is reused early) however the caller iterates
        done = [self._collect() for _ in range(len(self._inflight) - self._depth)]
        yield from done

    def flush(self):
        """Yield every tick still in flight, oldest first."""
        while self._inflight:
            yield self._collect()
