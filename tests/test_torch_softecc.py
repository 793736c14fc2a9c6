"""Port ECC, soft decoding and the bit helpers (mbe_tpu_torch.ops) against
the JAX package and the reference's golden vectors. All bit-exact
(tolerance 0): keys, corrected bits, error counts and packed values are
integers.

Kernel B2 itself runs only on the card (tests/test_torch_cuda.py); here
its plain version is held against the JAX Pallas kernel in interpret
mode, and the kernel's own arithmetic (csrc/softecc.cu: the bf16 wgmma
product, a float min per 64-codeword group), emulated step by step in
numpy, against the plain version. Its operands are checked exact in bf16,
and its codebook layout is read back by the wgmma descriptors' address
arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbe_tpu.ops import bits as jbits
from mbe_tpu.ops.pallas import softecc as jsoftecc
from mbe_tpu.tables import T as JT
from mbe_tpu_torch.ops import bits, ecc
from mbe_tpu_torch.ops.cuda import build, softecc

torch.set_num_threads(1)

R = 256
CODES = ("golay", "hamstd", "ham7100")
REL_CASES = ("random", "const7", "zero", "max255")


def _inputs(code, case, rows=R, seed=42):
    """Random hard bits, reliabilities of one case, and the hard decode's
    codeword index (the main path's idx_hard)."""
    n = softecc.CODES[code].n
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, (rows, n)).astype(np.int32)
    rel = {"random": rng.integers(0, 256, (rows, n)),
           "const7": np.full((rows, n), 7),
           "zero": np.zeros((rows, n)),
           "max255": np.full((rows, n), 255)}[case].astype(np.int32)
    return b, rel, ecc.hard_index(torch.from_numpy(b), code).numpy()


@pytest.mark.parametrize("case", REL_CASES)
@pytest.mark.parametrize("code", CODES)
def test_plain_keys_match_pallas_interpret(code, case):
    """The plain soft_decode_keys_reference equals the JAX Pallas kernel (interpret
    mode, R = 256, as tests/test_pallas.py runs it), key for key. The
    constant and zero reliabilities leave the tie-break alone to decide."""
    b, rel, idx = _inputs(code, case)
    got = softecc.soft_decode_keys_reference(torch.from_numpy(b), torch.from_numpy(rel),
                                             torch.from_numpy(idx), code).numpy()
    args = (jnp.asarray(b), jnp.asarray(rel), jnp.asarray(idx))
    if code == "golay":
        want = jsoftecc.golay2312_soft_keys(*args, JT.golay_codewords, interpret=True)
    else:
        v7 = code == "ham7100"
        cb = JT.hamming_codewords_7100 if v7 else JT.hamming_codewords_std
        want = jsoftecc.hamming1511_soft_keys(*args, cb, v7, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def _bf16(x):
    """x through torch.bfloat16 and back to float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _operand_a(b, rel, code):
    """The kernel's A rows (csrc/softecc.cu:load_rows), int64 [R, K]:
    q_i = rel_i * (1 - 2 b_i), then h_j = b_j for j >= data_lo, two ones,
    zeros to K."""
    spec = softecc.CODES[code]
    n, lo = spec.n, spec.data_lo
    b, rel = b.astype(np.int64), rel.astype(np.int64)
    a = np.zeros((len(b), softecc.k_padded(code)), np.int64)
    a[:, :n] = rel * (1 - 2 * b)
    a[:, n:2 * n - lo] = b[:, lo:]
    a[:, 2 * n - lo:2 * n - lo + 2] = 1
    return a


def _kernel_emulation(b, rel, idx_hard, code):
    """csrc/softecc.cu's arithmetic in numpy: A and B as bf16 values, the
    product in float32, a float min over each thread's 16 columns of a
    64-codeword group (m64n128 accumulator: column 64g + 8j + 2*(lane % 4)
    + e), the int key once per (thread, group), an int min over groups,
    slices and the lane quad, then the exact hard candidate."""
    spec = softecc.CODES[code]
    packed = softecc._kernel_tables(code, torch.device("cpu"))[1].numpy()
    n, lo, sd = spec.n, spec.data_lo, spec.shift_diff
    b, w = b.astype(np.int64), rel.astype(np.int64)
    d = _bf16(_operand_a(b, w, code)) @ _bf16(softecc.operand_b(code))  # [R, ncw], exact
    rows, ncw = d.shape
    m = d.reshape(rows, ncw // 64, 8, 4, 2).min(axis=(2, 4)).astype(np.int64)  # [R, group, lane % 4]
    t = m + (64 * (32 * (w * b).sum(axis=1) + b[:, lo:].sum(axis=1) + 16))[:, None, None]
    keys = ((t >> 6) << sd) | (np.arange(0, ncw, 64)[None, :, None] + (t & 63))
    best = keys.reshape(rows, -1).min(axis=1)
    bword = (b << np.arange(n)).sum(axis=1)
    mism = bword ^ packed[np.clip(idx_hard, 0, ncw - 1)]
    score = (w * ((mism[:, None] >> np.arange(n)) & 1)).sum(axis=1)
    diffs = np.array([bin(int(x) >> lo).count("1") for x in mism])
    hard = ((32 * score + diffs) << sd) | idx_hard
    return np.where((idx_hard >= 0) & (idx_hard < ncw), np.minimum(best, hard), best)


@pytest.mark.parametrize("case", REL_CASES)
@pytest.mark.parametrize("code", CODES)
def test_kernel_arithmetic_matches_plain(code, case):
    """The kernel's factored key (64*v + group place in one exact float
    from the bf16 product, the hard candidate added at the end) gives the
    plain keys, at a ragged row count and with out-of-range idx_hard rows
    (no candidate matches)."""
    b, rel, idx = _inputs(code, case, rows=300, seed=5)
    idx[:3] = (-1, 4096, 1 << 20)
    want = softecc.soft_decode_keys_reference(torch.from_numpy(b), torch.from_numpy(rel),
                                              torch.from_numpy(idx), code).numpy()
    np.testing.assert_array_equal(_kernel_emulation(b, rel, idx, code), want)


@pytest.mark.parametrize("case", REL_CASES)
@pytest.mark.parametrize("code", CODES)
def test_kernel_operands_exact_in_bf16(code, case):
    """Every A and B value survives a round trip through torch.bfloat16,
    and the sum of |terms| of every (row, codeword) product stays below
    2^24, so FP32 accumulation is exact in any order (max255 is the worst
    case: 12,013,887 for Golay)."""
    b, rel, _ = _inputs(code, case)
    a = _operand_a(b, rel, code).astype(np.float32)
    bb = softecc.operand_b(code)
    np.testing.assert_array_equal(_bf16(a), a)
    np.testing.assert_array_equal(_bf16(bb), bb)
    terms = np.abs(a).astype(np.float64) @ np.abs(bb).astype(np.float64)
    assert terms.max() < 2 ** 24


# csrc/softecc.cu's descriptor arithmetic: a block's slice of 2048
# codewords from shared-memory byte 0, LBO 128 B (the next core matrix
# along K), SBO 16*K B (the next 8-codeword group), chunks of 128
# codewords 128/8*K 16-byte units apart, k-steps 16 units (256 B) apart
SLICE, CHUNK = 2048, 128


def _descriptor(addr, lbo, sbo):
    return ((addr & 0x3FFFF) >> 4) | (((lbo & 0x3FFFF) >> 4) << 16) | (((sbo & 0x3FFFF) >> 4) << 32)


def _wgmma_reads_b(smem, desc):
    """What m64n128k16 reads as B [16, 128] for `desc` (K-major, no
    swizzle): element (k, n) at start + (n / 8) SBO + (k / 8) LBO +
    (n % 8) 16 + (k % 8) 2 bytes."""
    assert desc >> 62 == 0 and (desc >> 49) & 7 == 0  # no swizzle, base offset 0
    start, lbo, sbo = (((desc >> f) & 0x3FFF) << 4 for f in (0, 16, 32))
    k, n = np.meshgrid(np.arange(16), np.arange(CHUNK), indexing="ij")
    addr = start + (n // 8) * sbo + (k // 8) * lbo + (n % 8) * 16 + (k % 8) * 2
    assert addr.max() < smem.size * 2
    return smem[addr // 2]


@pytest.mark.parametrize("code", CODES)
def test_wgmma_layout_reads_back_by_descriptor(code):
    """The host-laid codebook, read back by the kernel's descriptors (every
    slice, chunk and k-step), is the logical [K, ncw] B operand."""
    b = softecc.operand_b(code)
    kp, ncw = b.shape
    flat = softecc.wgmma_layout(b).float().numpy()
    got = np.full_like(b, np.nan)
    for sl in range(ncw // SLICE):
        smem = flat[sl * SLICE * kp:(sl + 1) * SLICE * kp]
        desc0 = _descriptor(0, 128, 16 * kp)
        for j in range(SLICE // CHUNK):
            for s in range(kp // 16):
                c0 = sl * SLICE + j * CHUNK
                got[16 * s:16 * s + 16, c0:c0 + CHUNK] = _wgmma_reads_b(
                    smem, desc0 + j * (CHUNK // 8 * kp) + 16 * s)
    np.testing.assert_array_equal(got, b)


@pytest.mark.parametrize("code", CODES)
def test_soft_decoders_vs_reference_vectors(vectors, code):
    """golay2312_soft / hamming1511_soft (both generators) against the
    reference's soft outputs in ecc.npz."""
    v = vectors("ecc")
    if code == "golay":
        out, errs = ecc.golay2312_soft(torch.from_numpy(v["golay_in"]),
                                       torch.from_numpy(v["golay_rel"]))
        key = "golay_soft"
    else:
        out, errs = ecc.hamming1511_soft(torch.from_numpy(v["ham_in"]),
                                         torch.from_numpy(v["ham_rel"]), code == "ham7100")
        key = "ham7100_soft" if code == "ham7100" else "ham_soft"
    np.testing.assert_array_equal(out.numpy(), v[f"{key}_out"])
    np.testing.assert_array_equal(errs.numpy(), v[f"{key}_errs"])


def test_soft_decoders_keep_leading_batch_dims():
    """[C, 3, n] blocks decode as the same rows flattened."""
    b, rel, _ = _inputs("golay", "random", rows=48)
    out3, err3 = ecc.golay2312_soft(torch.from_numpy(b).reshape(16, 3, 23),
                                    torch.from_numpy(rel).reshape(16, 3, 23))
    out, err = ecc.golay2312_soft(torch.from_numpy(b), torch.from_numpy(rel))
    assert torch.equal(out3.reshape(48, 23), out) and torch.equal(err3.reshape(48), err)


def test_hard_decoders_vs_reference_vectors(vectors):
    """The packed hard decoders, with both Hamming generators, against
    ecc.npz (golay_hard_out, ham_hard_out, ham7100_hard_out)."""
    v = vectors("ecc")
    out, errs = ecc.golay2312_hard_packed(ecc._pack_lsb(torch.from_numpy(v["golay_in"])))
    np.testing.assert_array_equal(ecc._unpack_lsb(out, 23).numpy(), v["golay_hard_out"])
    np.testing.assert_array_equal(errs.numpy(), v["golay_hard_errs"])
    words = ecc._pack_lsb(torch.from_numpy(v["ham_in"]))
    for v7, key in ((False, "ham"), (True, "ham7100")):
        out, errs = ecc.hamming1511_hard_packed(words, variant7100=v7)
        np.testing.assert_array_equal(ecc._unpack_lsb(out, 15).numpy(), v[f"{key}_hard_out"])
        np.testing.assert_array_equal(errs.numpy(), v[f"{key}_hard_errs"])


# codeword bit positions of index bits 0.. (ecc.c:138-155)
_DATA_POS = {"golay": tuple(range(11, 23)),
             "hamstd": (2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14),
             "ham7100": tuple(range(4, 15))}


@pytest.mark.parametrize("code", CODES)
def test_hard_index_is_hard_decoded_data_word(vectors, code):
    """hard_index equals the data bits of the reference's hard decode
    (ecc.npz), read at the codebook's index positions."""
    v = vectors("ecc")
    key = {"golay": "golay", "hamstd": "ham", "ham7100": "ham7100"}[code]
    inp = v["golay_in" if code == "golay" else "ham_in"]
    data = v[f"{key}_hard_out"][..., list(_DATA_POS[code])].astype(np.int64)
    want = (data << np.arange(data.shape[-1])).sum(axis=-1)
    np.testing.assert_array_equal(ecc.hard_index(torch.from_numpy(inp), code).numpy(), want)


def test_bit_helpers_match_jax():
    rng = np.random.default_rng(9)
    b = rng.integers(0, 2, (40, 3, 24)).astype(np.int32)
    idx = [5, 0, 23, 7, 7, 12]
    np.testing.assert_array_equal(bits.pack_msb_first(torch.from_numpy(b), idx).numpy(),
                                  np.asarray(jbits.pack_msb_first(jnp.asarray(b), idx)))
    np.testing.assert_array_equal(bits.pack_descending(torch.from_numpy(b), 22, 11).numpy(),
                                  np.asarray(jbits.pack_descending(jnp.asarray(b), 22, 11)))
    llr = rng.integers(-400, 400, 500).astype(np.int32)
    for got, want in zip(bits.soft_bit_from_llr(torch.from_numpy(llr)),
                         jax.jit(jbits.soft_bit_from_llr)(llr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(bits.soft_bits_from_hard(torch.from_numpy(b), 99),
                         jbits.soft_bits_from_hard(jnp.asarray(b), 99)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    """The soft decoders of ops/ecc.py, the kernel's one caller, run the
    plain version for CPU tensors (no launch counted); the kernel's entry
    raises on a tensor on the CPU or meta device, and for an unknown code."""
    b, rel, idx = (torch.from_numpy(x) for x in _inputs("hamstd", "random", rows=8))
    before = build.LAUNCHES["soft_decode"].n
    assert torch.equal(ecc._soft_keys(b, rel, "hamstd"),
                       softecc.soft_decode_keys_reference(b, rel, idx, "hamstd"))
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match=f"no kernel for device {device}"):
            softecc.soft_decode_keys(b.to(device), rel.to(device), idx.to(device), "hamstd")
    assert build.LAUNCHES["soft_decode"].n == before
    with pytest.raises(ValueError, match="unknown code"):
        softecc.soft_decode_keys(b, rel, idx, "golay24")
