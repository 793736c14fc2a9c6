"""Bit validation, table lookup, packing and soft-bit helpers (port of
mbe_tpu.ops.bits)."""

from functools import lru_cache

import numpy as np
import torch

STATUS_OK = 0
STATUS_INVALID_ARGUMENT = -1
STATUS_INVALID_BITS = -2


def validate_bits_host(bits) -> int:
    """Host-side strict 0/1 validation (mbe_result.h:18-29) of a numpy
    array. Returns the status."""
    arr = np.asarray(bits)
    if arr.size == 0:
        return STATUS_OK
    return STATUS_OK if ((arr == 0) | (arr == 1)).all() else STATUS_INVALID_BITS


def validate_soft_bits_host(bits) -> int:
    """Host-side soft-bit validation: the bit field must lie in 0..1
    (mbe_result.h:31-42). Returns the status."""
    arr = np.asarray(bits)
    if arr.size == 0:
        return STATUS_OK
    return STATUS_OK if ((arr >= 0) & (arr <= 1)).all() else STATUS_INVALID_BITS


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


@lru_cache(maxsize=None)
def _pack_index(indices, device):
    return (torch.as_tensor(indices, dtype=torch.long, device=device),
            torch.arange(len(indices) - 1, -1, -1, device=device))


def pack_msb_first(bits, indices):
    """mbe_bits_by_index_to_int (mbe_bitpack.h:11-19): MSB-first pack of
    bits[..., indices] into int32. The index tensors are cached per device."""
    idx, shifts = _pack_index(tuple(indices), bits.device)
    return ((bits[..., idx].to(torch.int32) << shifts).sum(dim=-1)).to(torch.int32)


@lru_cache(maxsize=None)
def powers_of_two(n, device):
    """[n] int64 weights 2^0 .. 2^(n-1) on `device` (an LSB-first pack of a
    row of bit planes), built once per device."""
    return torch.as_tensor([1 << i for i in range(n)], dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def _field_index(rows, device):
    return (torch.as_tensor(rows, device=device),
            torch.arange(len(rows) - 1, -1, -1, device=device)[:, None])


def field(d, rows):
    """Value of rows `rows` of channel-minor int32 bit planes d [n, C], the
    first row the MSB; [C] int32. The index tensors are cached per device."""
    idx, shifts = _field_index(tuple(rows), d.device)
    return (d[idx] << shifts).sum(dim=0, dtype=torch.int32)


def pack_descending(bits, high, low=0):
    """mbe_bits_descending_to_int (mbe_bitpack.h:21-27): value from
    bits[..., high..low], bit `high` is the MSB."""
    return pack_msb_first(bits, range(high, low - 1, -1))


def soft_bit_from_llr(llr):
    """mbe_softBitFromLlr (mbelib.c:125-132): llr > 0 -> bit 1;
    reliability = clamp(|llr|, 0, 255). Returns (bit, reliability) int32."""
    llr = torch.as_tensor(llr).to(torch.int32)
    return (llr > 0).to(torch.int32), torch.clamp(llr.abs(), 0, 255)


def soft_bits_from_hard(bits, reliability=255):
    """mbe_softBitsFromHard (mbelib.c:134-147)."""
    b = torch.as_tensor(bits).to(torch.int32)
    return b, torch.full_like(b, reliability)
