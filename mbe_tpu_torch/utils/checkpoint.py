"""Channel-state snapshot / resume (port of mbe_tpu.utils.checkpoint).

The complete resumable state of every stream is the ChannelState (the
reference's equivalent is the caller-owned mbe_parms triplet). A snapshot
is one npz with the JAX package's keys and dtypes (`cur.<field>`,
`prev.<field>`, `enh.<field>`, `comfort_rng`, `lcg_prime`; the
uint32-valued leaves as uint32), so a snapshot written by either package
loads in the other; loading restores decoding bit for bit.
"""

import types

import numpy as np

from ..models.state import (PARMS_FIELDS, ChannelState, checked_device, state_from_numpy,
                            state_to_numpy)


def save(path, state: ChannelState) -> None:
    """Write `state` to the npz at `path` (compressed)."""
    host = state_to_numpy(state)
    leaves = {}
    for name in ("cur", "prev", "enh"):
        p = getattr(host, name)
        if p is None:  # slim IMBE carry (init_state(carry_enh=False))
            continue
        for k in PARMS_FIELDS:
            leaves[f"{name}.{k}"] = getattr(p, k)
    leaves["comfort_rng"] = host.comfort_rng
    leaves["lcg_prime"] = host.lcg_prime
    np.savez_compressed(path, **leaves)


def load(path, device="cuda") -> ChannelState:
    """The state saved at `path`, on `device` (the GPU by default; without
    one that raises)."""
    device = checked_device(device)
    with np.load(path, allow_pickle=False) as data:
        data = dict(data)

    def parms(prefix):
        if f"{prefix}.w0" not in data:
            return None
        return types.SimpleNamespace(**{k: data[f"{prefix}.{k}"] for k in PARMS_FIELDS})

    tree = types.SimpleNamespace(cur=parms("cur"), prev=parms("prev"), enh=parms("enh"),
                                 comfort_rng=data["comfort_rng"], lcg_prime=data["lcg_prime"])
    return state_from_numpy(tree, device)
