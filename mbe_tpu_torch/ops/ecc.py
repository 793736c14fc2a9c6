"""Packed-word Golay(23,12) / Hamming(15,11) hard decoders (port of the
hard paths of mbe_tpu.ops.ecc; reference: ecc.c).

Codewords live in the low bits of an integer lane, LSB-first (Golay:
parity 0..10, data 11..22). Syndromes are parities over generator masks;
the syndrome -> correction step is a lookup in the reference's own
tables (golayMatrix, ham1511_lut).
"""

from functools import lru_cache

import numpy as np
import torch

from ..tables import T, table
from .bits import lookup


def _parity(x):
    """Bitwise parity of each lane (values < 2^23) via xor-folds."""
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _popcount12(x):
    """Population count of 12-bit lanes."""
    x = x - ((x >> 1) & 0x555)
    x = (x & 0x333) + ((x >> 2) & 0x333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def popcount32(x):
    """Population count of non-negative 32-bit lanes (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


@lru_cache(maxsize=1)
def _golay_gp_masks():
    """gp[p] = data-word mask whose parity gives expected parity bit p:
    sum_i [golayGenerator[i] has bit p] << (11-i) (ecc.c:237-244)."""
    gg = np.asarray(T.golayGenerator, np.int64)
    gp = [0] * 11
    for p in range(11):
        for i in range(12):
            if (gg[i] >> p) & 1:
                gp[p] |= 1 << (11 - i)
    return tuple(gp)


def golay_mask_from_syndrome(s11):
    """Data-bit correction mask for an 11-bit Golay syndrome: the
    reference's 2048-entry golayMatrix (ecc_const.c)."""
    return lookup(table("golayMatrix", s11.device), s11).to(s11.dtype)


def golay2312_hard_packed(word):
    """Packed-word Golay(23,12) hard decode (ecc.c:259-301).

    Args: word [...] int — codeword in the low 23 bits.
    Returns: (out_word with corrected data / untouched parity bits, errs)
    — errs counts corrected data-bit errors. Both int32.
    """
    word = word.to(torch.int32)
    data = word >> 11
    ecc_in = word & 0x7FF
    syndrome = torch.zeros_like(data)
    for p, gp in enumerate(_golay_gp_masks()):
        syndrome = syndrome | ((_parity(data & gp) ^ ((ecc_in >> p) & 1)) << p)
    corrected = data ^ golay_mask_from_syndrome(syndrome)
    errs = _popcount12(data ^ corrected)
    return (corrected << 11) | ecc_in, errs


def hamming1511_hard_packed(block):
    """Packed-word Hamming(15,11) hard decode with the standard generator
    (ecc.c:366-464). Returns (corrected block, errs) — 0/1 errors
    corrected; int32."""
    block = block.to(torch.int32)
    syndrome = torch.zeros_like(block)
    for p, g in enumerate(np.asarray(T.hammingGenerator).tolist()):
        syndrome = syndrome | (_parity(block & g) << p)
    corrected = block ^ lookup(table("ham1511_lut", block.device), syndrome)
    return corrected, (syndrome > 0).to(torch.int32)
