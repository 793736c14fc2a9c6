"""Soft-decision ML ECC decode: the hand-written CUDA kernel
(csrc/softecc.cu) and its plain PyTorch version.

For each row r of hard bits, reliabilities 0..255 and the codeword index
of the row's hard decode, the winning key over every codeword c is

    key = (score << s_score) | ((c != idx_hard) << s_match)
          | (diffs << s_diff) | c
    score = sum_i rel_i * [bit_i != cw_i]
    diffs = Hamming distance of bits[data_lo:] from cw[data_lo:]

an int32 whose order is the reference's tie-break (ecc.c:54-67). The
codebooks are index-systematic (codeword index == data word), so the
winner's index and diffs unpack from the key by shifts.
`soft_decode_keys` launches the kernel; its one caller, ops/ecc._soft_keys,
runs `soft_decode_keys_reference` for CPU tensors instead.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...tables import T, table
from . import build


@dataclasses.dataclass(frozen=True)
class Code:
    n: int
    data_lo: int
    shift_score: int
    shift_match: int
    shift_diff: int
    codebook: str   # the [ncw, n] codeword table in tables.npz
    kernel_id: int  # the C entry's `code`: 0 Golay, 1 Hamming


CODES = {
    "golay": Code(23, 11, 17, 16, 12, "golay_codewords", 0),
    "hamstd": Code(15, 0, 16, 15, 11, "hamming_codewords_std", 1),
    "ham7100": Code(15, 0, 16, 15, 11, "hamming_codewords_7100", 1),
}

KERNEL = build.register(build.Kernel("soft_decode", build.CSRC / "softecc.cu",
                                     "mbe_soft_decode_keys",
                                     [build.PTR] * 6 + [build.INT, build.INT, build.PTR], None))


def soft_decode_keys_reference(bits, rel, idx_hard, code):
    """The keys by a float32 matmul over the whole codebook and a min, the
    XLA form of mbe_tpu/ops/ecc.py:_soft_decode. Exact: every product and
    sum is an integer below 2^24 (and TF32 is pinned off). Shapes as
    soft_decode_keys; it materializes [R, ncw] tensors."""
    spec = CODES[code]
    cw = table(spec.codebook, bits.device).to(torch.float32)   # [ncw, n]
    bits = bits.to(torch.int32)
    rel = rel.to(torch.int32)
    base = (rel * bits).sum(dim=-1, dtype=torch.int32)
    q = (rel * (1 - 2 * bits)).to(torch.float32)
    score = base[:, None] + (q @ cw.T).to(torch.int32)
    h = bits[:, spec.data_lo:].to(torch.float32)
    cwd = cw[:, spec.data_lo:]
    diffs = (h.sum(dim=-1)[:, None] + cwd.sum(dim=-1)[None, :]
             - 2.0 * (h @ cwd.T)).to(torch.int32)
    idx = torch.arange(cw.shape[0], dtype=torch.int32, device=bits.device)
    nomatch = (idx[None, :] != idx_hard.to(torch.int32)[:, None]).to(torch.int32)
    key = ((score << spec.shift_score) | (nomatch << spec.shift_match)
           | (diffs << spec.shift_diff) | idx)
    return key.amin(dim=-1)


def k_padded(code):
    """Columns of the kernel's A and B operands: n q columns, n - data_lo h
    columns and two ones, padded to wgmma's k16 (48 Golay, 32 Hamming)."""
    spec = CODES[code]
    return -(-(2 * spec.n - spec.data_lo + 2) // 16) * 16


def operand_b(code):
    """The kernel's B operand, float32 [K, ncw] of integers exact in bf16:
    rows 2048*cw_i, -128*cw_j (j >= data_lo), 64*popcount(cw[data_lo:]),
    c % 64, then zeros; A[r] @ B[:, c] plus the row constant is
    64*v + (c % 64) (csrc/softecc.cu)."""
    spec = CODES[code]
    cw = np.asarray(getattr(T, spec.codebook), np.int64)
    ncw, n, lo = cw.shape[0], spec.n, spec.data_lo
    b = np.zeros((k_padded(code), ncw), np.float32)
    b[:n] = 2048 * cw.T
    b[n:2 * n - lo] = -128 * cw[:, lo:].T
    b[2 * n - lo] = 64 * cw[:, lo:].sum(axis=1)
    b[2 * n - lo + 1] = np.arange(ncw) % 64
    return b


def wgmma_layout(b):
    """B [K, ncw] in the byte order the kernel's wgmma descriptors read
    (K-major, no swizzle): codewords in groups of 8, each group 8 x K
    bf16 as K/8 core matrices of 8 codewords x 8 k (128 contiguous bytes,
    one codeword's 8 k values per 16 bytes). Flat bf16 [K * ncw]."""
    k, ncw = b.shape
    t = torch.from_numpy(np.ascontiguousarray(b.T)).to(torch.bfloat16)  # [ncw, K]
    return t.reshape(ncw // 8, 8, k // 8, 8).permute(0, 2, 1, 3).reshape(-1)


@lru_cache(maxsize=None)
def _kernel_tables(code, device):
    """The kernel's codebook: its B operand in descriptor order (bf16,
    `wgmma_layout(operand_b(code))`) and the packed codewords int32
    [ncw], LSB-first."""
    spec = CODES[code]
    cw = np.asarray(getattr(T, spec.codebook), np.int64)
    packed = (cw << np.arange(spec.n)).sum(axis=1).astype(np.int32)
    return (wgmma_layout(operand_b(code)).to(device),
            torch.from_numpy(packed).to(device))


def soft_decode_keys(bits, rel, idx_hard, code):
    """Winning int32 keys [R] of the exhaustive soft ML decode.

    Args:
      bits, rel: [R, n] int32, contiguous — hard bits (0/1) and
        reliabilities (0..255); n = 23 for "golay", 15 for the Hamming codes.
      idx_hard: [R] int32 — the codeword index of each row's hard decode.
      code: "golay", "hamstd" (standard Hamming generator) or "ham7100".
    """
    if code not in CODES:
        raise ValueError(f"soft_decode_keys: unknown code {code!r}")
    spec = CODES[code]
    r = bits.shape[0]
    device = build.check("soft_decode_keys", [("bits", bits, torch.int32, (r, spec.n)),
                                              ("rel", rel, torch.int32, (r, spec.n)),
                                              ("idx_hard", idx_hard, torch.int32, (r,))])
    key = torch.empty((r,), dtype=torch.int32, device=device)
    KERNEL.launch(device, bits, rel, idx_hard, *_kernel_tables(code, device), key, r,
                  spec.kernel_id)
    return key
