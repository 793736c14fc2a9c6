"""Channel data parallelism over devices (port of mbe_tpu.parallel.sharding).

The decoder has no cross-channel math: each channel's state lives on one
device and the hot path has no collectives. So the reference's
`jax.sharding.Mesh` over channels becomes a list of devices, its sharded
arrays a list of per-device shards, and its jitted, donated step a
`pipeline.CompiledStep` per shard, each on its own device and stream. State
leaves are channel-minor (scalars [C], band arrays [57, C]) and split on
their trailing axis; frames and PCM are channel-major and split on their
leading one. `torch.tensor_split` cuts both the same way.
"""

import os

import torch

from .. import pipeline
from ..models import state as state_mod
from ..models.state import ChannelState, checked_device
from ..utils import graphs


def channel_mesh(devices=None) -> list:
    """The devices that channels are split over, as torch.device: every
    CUDA device by default (raising without one, as init_state does), or
    the given list, for example ["cpu", "cpu"] or ["cuda:0", "cuda:0"]."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu', ...] for the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [checked_device(d) for d in devices]


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


class _Shards:
    """A CompiledStep and a stream per shard, built at the first call. With
    `donate`, the first call's shard states become the static states (they
    are updated in place); otherwise they are copied in and left intact. A
    later call that passes other state objects than the ones returned
    copies them in."""

    def __init__(self, codec, mesh, donate):
        self.codec, self.mesh, self.donate = codec, list(mesh), donate
        self.steps, self.streams = None, None

    def bind(self, states):
        if len(states) != len(self.mesh):
            raise ValueError(f"{len(states)} shard states for a mesh of {len(self.mesh)}")
        if self.steps is None:
            own = states if self.donate else [state_mod.map_state(torch.clone, s)
                                               for s in states]
            self.steps = [pipeline.CompiledStep(self.codec, s) for s in own]
            self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                            for d in self.mesh]
        else:
            for step, s in zip(self.steps, states):
                if s is not step.state:
                    graphs.copy_into(graphs.leaves(step.state), graphs.leaves(s))
        return self.steps

    def run(self, work, states):
        """work(i, step) on each shard's stream, after the caller's streams
        on the first device and on the shard's; the caller's stream on the
        first device then waits for every shard (an event each)."""
        steps = self.bind(states)
        first = self.mesh[0]
        out = []
        for i, (step, stream) in enumerate(zip(steps, self.streams)):
            if stream is None:
                out.append(work(i, step))
                continue
            for d in {first, stream.device}:
                if d.type == "cuda":
                    stream.wait_stream(torch.cuda.current_stream(d))
            with torch.cuda.stream(stream):
                out.append(work(i, step))
        if first.type == "cuda":
            for stream in self.streams:
                if stream is not None:
                    torch.cuda.current_stream(first).wait_stream(stream)
        return [s.state for s in steps], out


def _gather(parts, dim, device):
    """The shards' outputs concatenated on `device`. A part made on a
    shard's stream is marked used on the gathering stream, so its memory
    is not reused before the concatenation has read it."""
    for p in parts:
        if p.is_cuda:
            p.record_stream(torch.cuda.current_stream(p.device))
    return torch.cat([p.to(device) for p in parts], dim=dim)


def sharded_step(codec: str, mesh, donate: bool = True):
    """The compiled decode + synth step with channel-sharded input and
    output: fn(frame [C, rows, cols], shard states) -> (shard states',
    pcm [C, 160], result dict of [C]). Frames split on their leading axis;
    each shard replays its own CompiledStep on its device and stream; the
    PCM and results are concatenated on the first device. `donate=True`
    consumes the shard states in place (as the reference's
    donate_argnums=(1,)); `donate=False` copies them in first."""
    shards = _Shards(codec, mesh, donate)

    def fn(frame, states):
        parts = torch.tensor_split(frame, len(shards.mesh), dim=0)

        def work(i, step):
            _, audio, res = step(parts[i])
            return audio, res

        states, out = shards.run(work, states)
        first = shards.mesh[0]
        pcm = _gather([a for a, _ in out], 0, first)
        res = {k: _gather([r[k] for _, r in out], 0, first) for k in out[0][1]}
        return states, pcm, res

    return fn


def sharded_sequence(codec: str, mesh):
    """The compiled step over [T, C, rows, cols] frames with channel
    sharding, the shard states donated: fn(frames, shard states) ->
    (shard states', pcm [T, C, 160], results dict of [T, C])."""
    shards = _Shards(codec, mesh, donate=True)

    def fn(frames, states):
        parts = torch.tensor_split(frames, len(shards.mesh), dim=1)
        states, out = shards.run(lambda i, step: pipeline.replay_sequence(step, parts[i]),
                                 states)
        first = shards.mesh[0]
        pcm = _gather([p for p, _ in out], 1, first)
        res = {k: _gather([r[k] for _, r in out], 1, first) for k in out[0][1]}
        return states, pcm, res

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
