"""Port bit domain (mbe_tpu_torch) — all bit-exact: hard Golay/Hamming
decoders, the demod keystream and the IMBE 7200 frame decode, against
the reference's golden vectors, big-int oracles and the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mbe_tpu.ops import demod as jdemod
from mbe_tpu.ops import ecc as jecc
from mbe_tpu_torch.models import imbe
from mbe_tpu_torch.ops import demod, ecc
from mbe_tpu_torch.tables import T

torch.set_num_threads(1)


def _pack(bits):
    """[N, n] LSB-first bit planes -> [N] int packed words."""
    return torch.from_numpy((bits.astype(np.int64) << np.arange(bits.shape[1])).sum(axis=1))


def _unpack(words, n):
    return ((words.numpy()[:, None] >> np.arange(n)) & 1).astype(np.int32)


def test_golay_hamming_hard_vs_reference_vectors(vectors):
    v = vectors("ecc")
    out, errs = ecc.golay2312_hard_packed(_pack(v["golay_in"]))
    np.testing.assert_array_equal(_unpack(out, 23), v["golay_hard_out"])
    np.testing.assert_array_equal(errs.numpy(), v["golay_hard_errs"])
    out, errs = ecc.hamming1511_hard_packed(_pack(v["ham_in"]))
    np.testing.assert_array_equal(_unpack(out, 15), v["ham_hard_out"])
    np.testing.assert_array_equal(errs.numpy(), v["ham_hard_errs"])


def test_golay_all_syndromes():
    """All 2048 syndromes: the port's lookup equals the reference's
    golayMatrix and the JAX package's algebraic IMLD."""
    s = torch.arange(2048, dtype=torch.int32)
    mask = ecc.golay_mask_from_syndrome(s).numpy()
    np.testing.assert_array_equal(mask, np.asarray(T.golayMatrix))
    np.testing.assert_array_equal(
        mask, np.asarray(jax.jit(jecc.golay_mask_from_syndrome)(jnp.arange(2048))))


def test_golay_corrects_up_to_three_errors():
    rng = np.random.default_rng(3)
    cw = np.asarray(T.golay_codewords[rng.integers(0, 4096, 256)], np.int32)
    bad = cw.copy()
    for i in range(len(bad)):
        bad[i, rng.choice(23, size=rng.integers(0, 4), replace=False)] ^= 1
    out, _ = ecc.golay2312_hard_packed(_pack(bad))
    np.testing.assert_array_equal(_unpack(out, 23)[:, 11:], cw[:, 11:])


def test_popcount_and_parity():
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 2**31, 1000))
    ref = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(ecc.popcount32(x).numpy(), ref)
    np.testing.assert_array_equal(ecc._parity(x & 0x7FFFFF).numpy(),
                                  [bin(int(v) & 0x7FFFFF).count("1") & 1 for v in x])
    np.testing.assert_array_equal(ecc._popcount12(x & 0xFFF).numpy(),
                                  [bin(int(v) & 0xFFF).count("1") for v in x])


def test_demod_keystream_vs_oracle_and_jax():
    rng = np.random.default_rng(1)
    seeds = (rng.integers(0, 4096, 64) * 16).astype(np.int32)
    bits = demod.prng_bits(torch.from_numpy(seeds), 114).numpy()
    for i in range(64):
        pr = int(seeds[i])
        for k in range(114):
            pr = (173 * pr + 13849) % 65536
            assert bits[k, i] == pr >> 15
    widths = (23, 23, 23, 15, 15, 15)
    kw = demod.prng_keywords(torch.from_numpy(seeds), widths).numpy()
    ref = np.asarray(jax.jit(lambda s: jdemod.prng_keywords(s, widths))(seeds))
    np.testing.assert_array_equal(kw, ref)


def test_decode_imbe7200_frame_vs_golden(vectors):
    """All 40 frames x 16 lanes of e2e_imbe7200 as one C=640 batch:
    imbe_d bits and the c0/protected/c4 error counts bit-exact."""
    v = vectors("e2e_imbe7200")
    T_, C = v["frames"].shape[:2]
    frames = torch.from_numpy(v["frames"].reshape(T_ * C, 8, 23))
    d, c0, prot, c4, words = imbe.decode_imbe7200_frame(frames)
    np.testing.assert_array_equal(d.T.numpy(), v["dbits"].reshape(T_ * C, 88))
    res = v["res"].reshape(T_ * C, 4)
    np.testing.assert_array_equal(c0.numpy(), res[:, 0])
    np.testing.assert_array_equal(prot.numpy(), res[:, 1])
    np.testing.assert_array_equal(c4.numpy(), res[:, 2])
    # the packed words and the bit planes are two views of one payload
    for a, b in zip(imbe.pack_imbe_words(d), words):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(imbe.expand_imbe_d(words).numpy(), d.numpy())
