"""Golay(23,12) / Hamming(15,11) hard and soft decoders (port of
mbe_tpu.ops.ecc; reference: ecc.c).

Hard: codewords live in the low bits of an integer lane, LSB-first
(Golay: parity 0..10, data 11..22). Syndromes are parities over generator
masks; the syndrome -> correction step is a lookup in the reference's own
tables (golayMatrix, ham1511_lut, ham1511_7100_lut). Bit planes are
packed into such words before a decode.

Soft: the exhaustive ML search is kernel B2 (ops/cuda/softecc.py), which
returns one int32 key per block; the winner's index and diffs unpack from
it by shifts.
"""

from functools import lru_cache

import numpy as np
import torch

from ..tables import T, table
from .bits import lookup
from .cuda import softecc


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


def hamming1511_hard_packed(block, variant7100=False):
    """Packed-word Hamming(15,11) hard decode (ecc.c:366-464) with the
    standard generator, or the IMBE 7100 one (imbe7100x4400.c). Returns
    (corrected block, errs) — 0/1 errors corrected; int32."""
    block = block.to(torch.int32)
    gen = T.imbe7100x4400hammingGenerator if variant7100 else T.hammingGenerator
    syndrome = torch.zeros_like(block)
    for p, g in enumerate(np.asarray(gen).tolist()):
        syndrome = syndrome | (_parity(block & g) << p)
    lut = table("ham1511_7100_lut" if variant7100 else "ham1511_lut", block.device)
    corrected = block ^ lookup(lut, syndrome)
    return corrected, (syndrome > 0).to(torch.int32)


def _pack_lsb(bits):
    """[..., n] bit planes -> [...] int32 words, bit i at position i."""
    shifts = torch.arange(bits.shape[-1], device=bits.device)
    return (bits.to(torch.int32) << shifts).sum(dim=-1).to(torch.int32)


def _unpack_lsb(word, n):
    """[...] words -> [..., n] int32 bit planes, bit i of the word at i."""
    return ((word[..., None] >> torch.arange(n, device=word.device)) & 1).to(torch.int32)


def golay2312_hard(bits):
    """Golay(23,12) hard decode of bit planes [..., 23] (LSB-first: parity
    0..10, data 11..22) over the packed form. Returns (out_bits [..., 23],
    errs [...]) int32: parity bits pass through uncorrected and errs counts
    corrected data-bit errors (ecc.c:259-301)."""
    word, errs = golay2312_hard_packed(_pack_lsb(bits))
    out = torch.cat([bits[..., :11].to(torch.int32), _unpack_lsb(word >> 11, 12)], dim=-1)
    return out, errs


def check_golay_block(block):
    """mbe_checkGolayBlock (ecc.c:221-251) on packed ints: the corrected
    12-bit data word of the 23-bit codeword in each lane's low bits."""
    return (golay2312_hard_packed(block.to(torch.int32) & 0x7FFFFF)[0] >> 11) & 0xFFF


def hamming1511_hard(bits, variant7100=False):
    """Hamming(15,11) hard decode of bit planes [..., 15] over the packed
    form. Returns (out_bits [..., 15], errs [...]) int32."""
    block, errs = hamming1511_hard_packed(_pack_lsb(bits), variant7100)
    return _unpack_lsb(block, 15), errs


def hard_index(bits, code):
    """Codeword index of the hard decode of blocks [..., n] under `code`
    ("golay", "hamstd" or "ham7100"): the codebooks are index-systematic,
    so it is the corrected data word, taken from the packed decode by
    shifts. Returns [...] int32."""
    word = _pack_lsb(bits)
    if code == "golay":
        return golay2312_hard_packed(word)[0] >> 11
    c, _ = hamming1511_hard_packed(word, code == "ham7100")
    if code == "ham7100":  # data bits at codeword bits 4..14
        return c >> 4
    # standard generator: data bits at codeword bits 2, 4..6, 8..14
    # (tools/gen_tables.py:159-168, from ecc.c:138-155)
    return ((c >> 2) & 1) | ((c >> 3) & 0xE) | ((c >> 4) & 0x7F0)


def _soft_keys(bits, rel, code):
    """softecc.soft_decode_keys, the kernel, for CUDA tensors and its plain
    form for CPU tensors, over any leading batch shape, with the blocks'
    hard decode as idx_hard."""
    n = bits.shape[-1]
    decode = (softecc.soft_decode_keys_reference if bits.device.type == "cpu"
              else softecc.soft_decode_keys)
    key = decode(
        bits.to(torch.int32).reshape(-1, n).contiguous(),
        rel.to(torch.int32).reshape(-1, n).contiguous(),
        hard_index(bits, code).reshape(-1).contiguous(), code)
    return key.reshape(bits.shape[:-1])


def golay2312_soft(bits, rel):
    """Soft Golay(23,12) (ecc.c:303-357): exhaustive ML over the 4096
    codewords with the reference's tie-break.

    bits/rel: [..., 23] int (hard decisions, reliabilities 0..255).
    Returns (out_bits [..., 23], data_diffs [...]) int32; the output keeps
    the input's hard parity bits (ecc.c:353-355).
    """
    key = _soft_keys(bits, rel, "golay")
    out = torch.cat([bits[..., :11].to(torch.int32), _unpack_lsb(key & 0xFFF, 12)], dim=-1)
    return out, (key >> 12) & 0xF


def hamming1511_soft(bits, rel, variant7100=False):
    """Soft Hamming(15,11) (ecc.c:157-215), diffs over all 15 bits.
    Returns (out_bits [..., 15], diffs [...]) int32."""
    key = _soft_keys(bits, rel, "ham7100" if variant7100 else "hamstd")
    packed = table("hamming_7100_packed" if variant7100 else "hamming_std_packed", bits.device)
    return _unpack_lsb(packed[(key & 0x7FF).long()], 15), (key >> 11) & 0xF
