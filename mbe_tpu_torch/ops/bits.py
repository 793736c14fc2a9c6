"""Bit validation and table lookup (port of mbe_tpu.ops.bits)."""

import torch


def bits_valid(bits):
    """Lane-wise validity: every bit of a lane in {0,1}. bits [C, ...];
    returns [C] bool."""
    flat = bits.reshape(bits.shape[0], -1)
    return ((flat == 0) | (flat == 1)).all(dim=-1)


def lookup(table, idx):
    """table[idx] with idx clamped to the table (the semantics of
    mbe_tpu.ops.bits.lut1d, which builds the same lookup from compares
    because gathers are slow on a TPU)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]
