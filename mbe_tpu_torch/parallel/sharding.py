"""Channel data parallelism over devices (port of mbe_tpu.parallel.sharding).

The decoder has no cross-channel math: each channel's state lives on one
device and the hot path has no collectives. So the reference's
`jax.sharding.Mesh` over channels becomes a list of devices, its sharded
arrays a list of per-device shards, and its jitted, donated step a
`pipeline.CompiledStep` per shard, each on its own device and stream. State
leaves are channel-minor (scalars [C], band arrays [57, C]) and split on
their trailing axis; frames and PCM are channel-major and split on their
leading one. `torch.tensor_split` cuts both the same way.

One host thread drives every shard, frame by frame: frame t is copied in
and replayed on each shard in turn, on the shard's stream, before frame
t + 1 (a round, the span `mbe.shard.round`). A graph launch that waits for
room in one card's queue then holds the thread only while the other cards
already have work queued.

`sharded_sequence` takes its frames in one of two forms. One tensor is
split over the mesh and the outputs are gathered onto the first device.
A list of per-shard tensors, each on its shard's device, gives per-shard
outputs on the same devices: nothing crosses devices in the call, as in a
site where each card's frames arrive for that card and its PCM is
consumed there.
"""

import contextlib
import os

import torch

from .. import pipeline
from ..models import state as state_mod
from ..models.state import ChannelState, checked_device
from ..utils import graphs
from ..utils.config import DEFAULT as DEFAULT_CONFIG, DecoderConfig
from ..utils.spans import span


def channel_mesh(devices=None) -> list:
    """The devices that channels are split over, as torch.device: every
    CUDA device by default (raising without one, as init_state does), or
    the given list, for example ["cpu", "cpu"] or ["cuda:0", "cuda:1"]. A
    CUDA device must name its index: "cuda" alone would be whichever
    device is current when a shard's work is enqueued."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu', ...] for the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [checked_device(d) for d in devices]
    for d in mesh:
        if d.type == "cuda" and d.index is None:
            raise ValueError(f"mesh device {d} has no index; name it, as cuda:0")
    return mesh


def state_spec(x) -> int:
    """The channel axis of one state leaf: the trailing one (the
    channel-minor layout rule of models/state.py)."""
    return x.ndim - 1


def shard_state(state: ChannelState, mesh) -> list:
    """One ChannelState per device of `mesh`: every leaf split on its
    channel axis by torch.tensor_split, each part a contiguous copy on its
    device (the shards share no memory with `state`)."""
    def part(x, i, device):
        view = torch.tensor_split(x, len(mesh), dim=state_spec(x))[i]
        return torch.empty(view.shape, dtype=view.dtype, device=device).copy_(view)

    return [state_mod.map_state(lambda x, i=i, d=d: part(x, i, d), state)
            for i, d in enumerate(mesh)]


def _on(stream):
    """The shard's stream as the current one (and its device as the
    current device); nothing for a CPU shard."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class _Shards:
    """A CompiledStep (codec, soft, int16, config) and a stream per shard,
    built at the first call from the shard states, each on its mesh
    device; `soft` is whether that call passes reliabilities. With
    `donate`, the first call's shard states become the static states
    (they are updated in place); otherwise they are copied in and left
    intact. A later call that passes other state objects than the ones
    returned copies them in."""

    def __init__(self, codec, mesh, donate, int16, config):
        self.codec, self.mesh, self.donate, self.config = codec, list(mesh), donate, config
        self.int16 = int16 or config.int16_output
        self.steps, self.streams = None, None

    def bind(self, states, soft):
        if self.steps is None:
            for i, (s, d) in enumerate(zip(states, self.mesh)):
                if s.lcg_prime.device != d:
                    raise ValueError(f"shard state {i} is on {s.lcg_prime.device}, "
                                     f"its mesh device is {d}")
            own = states if self.donate else [state_mod.map_state(torch.clone, s)
                                               for s in states]
            self.steps = [pipeline.CompiledStep(self.codec, s, soft, self.int16, self.config)
                          for s in own]
            self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                            for d in self.mesh]
        else:
            for step, s in zip(self.steps, states):
                if s is not step.state:
                    graphs.copy_into(graphs.leaves(step.state), graphs.leaves(s))
        return self.steps

    def parts(self, x, listed, states, name):
        """x's per-shard parts [T, C_i, rows, cols]: a list as given (one
        part per shard, each on its shard's device), or one tensor split
        on its channel axis; each part's shape checked against its
        shard's channels."""
        k = len(self.mesh)
        if isinstance(x, (list, tuple)) != listed:
            raise ValueError(f"{name}: a list and a tensor mixed; pass both as lists or both "
                             "as tensors")
        if not listed:
            x = torch.tensor_split(x, k, dim=1)
        elif len(x) != k:
            raise ValueError(f"{name}: {len(x)} parts for a mesh of {k}")
        frame = pipeline.FRAME_SHAPES[self.codec]
        t = x[0].shape[0]
        for i, (p, s, d) in enumerate(zip(x, states, self.mesh)):
            want = (t, s.lcg_prime.shape[0], *frame)
            if tuple(p.shape) != want or t < 1:
                raise ValueError(f"{name}: part {i} is {tuple(p.shape)}; its shard needs {want} "
                                 "with T >= 1")
            if listed and p.device != d:
                raise ValueError(f"{name}: part {i} is on {p.device}, its shard on {d}")
        return list(x)

    def run(self, frames, states, soft_rel):
        """Every frame on every shard, round by round, each shard on its
        stream: (shard states', pcm parts [T, C_i, 160], result parts, a
        dict of [T, C_i] int32 each), every part on its shard's device.
        Frames as a list (see `parts`) touch no other device: each
        shard's stream first waits for the current stream of its device,
        which then waits for it. Frames as one tensor also order the
        shards after, and then before, the first device's current
        stream, which gathers the outputs."""
        if len(states) != len(self.mesh):
            raise ValueError(f"{len(states)} shard states for a mesh of {len(self.mesh)}")
        listed = isinstance(frames, (list, tuple))
        parts = self.parts(frames, listed, states, "frames")
        rels = None if soft_rel is None else self.parts(soft_rel, listed, states, "soft_rel")
        steps = self.bind(states, rels is not None)
        for stream in self.streams:
            if stream is None:
                continue
            for d in {stream.device} if listed else {self.mesh[0], stream.device}:
                if d.type == "cuda":
                    stream.wait_stream(torch.cuda.current_stream(d))
        T = parts[0].shape[0]
        pcm, words, keys = [None] * len(steps), [None] * len(steps), None
        for t in range(T):
            with span("mbe.shard.round"):
                for i, (step, stream) in enumerate(zip(steps, self.streams)):
                    with _on(stream):
                        _, audio, res = step(parts[i][t], None if rels is None else rels[i][t])
                        if pcm[i] is None:
                            keys = tuple(res)
                            pcm[i] = torch.empty((T, *audio.shape), dtype=audio.dtype,
                                                 device=step.device)
                            words[i] = torch.empty((T, *step.words.shape), dtype=torch.int32,
                                                   device=step.device)
                        pcm[i][t].copy_(audio)
                        words[i][t].copy_(step.words)
        results = []
        for i, stream in enumerate(self.streams):
            with _on(stream):
                results.append({k: words[i][:, :, j].contiguous() for j, k in enumerate(keys)})
            if stream is None:
                continue
            # made on the shard's stream, used on the caller's: not reused
            # before the caller's stream has read them
            here = torch.cuda.current_stream(stream.device)
            here.wait_stream(stream)
            for x in (pcm[i], *results[i].values()):
                x.record_stream(here)
            if not listed and self.mesh[0].type == "cuda":
                torch.cuda.current_stream(self.mesh[0]).wait_stream(stream)
        return [s.state for s in steps], pcm, results


def _gather(parts, dim, device):
    """The shards' outputs concatenated on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def sharded_step(codec: str, mesh, donate: bool = True, int16: bool = False,
                 config: DecoderConfig = DEFAULT_CONFIG):
    """The compiled decode + synth step with channel-sharded input and
    output: fn(frame [C, rows, cols], shard states, soft_rel=None) ->
    (shard states', pcm [C, 160], result dict of [C]). Frames (and
    reliabilities) split on their leading axis; each shard replays its own
    CompiledStep(codec, soft, int16, config) on its device and stream; the
    PCM and results are concatenated on the first device. `donate=True`
    consumes the shard states in place (as the reference's
    donate_argnums=(1,)); `donate=False` copies them in first."""
    shards = _Shards(codec, mesh, donate, int16, config)

    def fn(frame, states, soft_rel=None):
        states, pcm, res = shards.run(frame[None], states,
                                      None if soft_rel is None else soft_rel[None])
        first = shards.mesh[0]
        return (states, _gather([p[0] for p in pcm], 0, first),
                {k: _gather([r[k][0] for r in res], 0, first) for k in res[0]})

    return fn


def sharded_sequence(codec: str, mesh, int16: bool = False,
                     config: DecoderConfig = DEFAULT_CONFIG):
    """The compiled step over a frame sequence with channel sharding, the
    shard states donated, each shard a CompiledStep(codec, soft, int16,
    config) on its device and stream, replayed in rounds (frame t on every
    shard, then frame t + 1): fn(frames, shard states, soft_rel=None).

    `frames` (and `soft_rel`, in the same form) is either
      - one tensor [T, C, rows, cols], split over the mesh: returns (shard
        states', pcm [T, C, 160], results dict of [T, C]), gathered onto
        the first device; or
      - a list of one [T, C_i, rows, cols] tensor per shard, each on its
        shard's device: returns (shard states', [pcm [T, C_i, 160]],
        [results dict of [T, C_i]]), each part on its shard's device and
        ready on that device's current stream. Nothing is copied between
        devices.
    A list of another length than the mesh, a part of another shape than
    its shard's, or a part on another device raises."""
    shards = _Shards(codec, mesh, True, int16, config)

    def fn(frames, states, soft_rel=None):
        states, pcm, res = shards.run(frames, states, soft_rel)
        if isinstance(frames, (list, tuple)):
            return states, pcm, res
        first = shards.mesh[0]
        return (states, _gather(pcm, 1, first),
                {k: _gather([r[k] for r in res], 1, first) for k in res[0]})

    return fn


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def global_channel_mesh() -> list:
    """This process's devices, the counterpart of a JAX process's
    addressable devices: with no collective in the hot path, a process
    never needs another's (each process decodes its own channel slice,
    host_local_slice).

    Without torch.distributed initialized it is every CUDA device
    (channel_mesh()). Initialized, with local rank r and local world size
    L (LOCAL_RANK and LOCAL_WORLD_SIZE, as torchrun sets them; without
    them the distributed rank and world size, which assumes one node) and
    n visible GPUs: L <= n gives the devices {i : i % L == r}, disjoint
    between the node's processes; L > n gives [cuda:(r % n)], so
    processes share a card."""
    devices = channel_mesh()
    if not _distributed():
        return devices
    dist = torch.distributed
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local <= len(devices):
        return [d for i, d in enumerate(devices) if i % local == rank]
    return [devices[rank % len(devices)]]


def host_local_channels(total_channels: int) -> int:
    """Channels owned by this process: total / the torch.distributed world
    size (1 when it is not initialized); the split must be exact."""
    world = torch.distributed.get_world_size() if _distributed() else 1
    if total_channels % world:
        raise ValueError(f"{total_channels} channels do not split over {world} processes")
    return total_channels // world


def host_local_slice(total_channels: int) -> slice:
    """The global channels this process owns: process p of P owns
    [p * C / P, (p + 1) * C / P), the order of the JAX mesh's devices and
    the counterpart of the index that make_array_from_callback passes to a
    JAX process. Raises as host_local_channels does when the split is not
    exact."""
    n = host_local_channels(total_channels)
    rank = torch.distributed.get_rank() if _distributed() else 0
    return slice(rank * n, (rank + 1) * n)
