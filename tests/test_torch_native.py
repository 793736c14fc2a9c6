"""The port's native host shim (mbe_tpu_torch.native, the port of
tests/test_native.py): native/mbe_host.c, built with the system C compiler
at first use and called through ctypes, against its numpy forms
(`*_reference`) and mbe_tpu.native's numpy fallbacks on the same seeded
inputs, out-of-range scatter indices included."""

import ctypes

import numpy as np
import pytest

from mbe_tpu import native as jnative
from mbe_tpu_torch import native
from mbe_tpu_torch.ops.cuda import build


def test_shim_is_built_from_the_repository_source():
    """The first call builds native/mbe_host.c into build/ (a library
    named by a hash of the source) and loads it; available() says so. The
    reference's own library is never loaded."""
    native.pack_bits(np.zeros((1, 8), np.int32))
    assert native.available()
    lib = native._lib()
    assert lib._name.startswith(str(build.BUILD_DIR / "mbe_host_"))
    assert "libmbehost" not in lib._name
    assert lib.mbe_host_version.restype is ctypes.c_int and lib.mbe_host_version() == 1


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (16, 96)).astype(np.int32)
    packed = native.pack_bits(bits)
    assert packed.shape == (16, 12) and packed.dtype == np.uint8
    np.testing.assert_array_equal(packed, native.pack_bits_reference(bits))
    np.testing.assert_array_equal(packed, jnative.pack_bits(bits))
    np.testing.assert_array_equal(native.unpack_bits(packed, 96), bits)


@pytest.mark.parametrize("n_bits", [49, 88, 96, 144, 168, 184, 1])
def test_pack_bits_matches_numpy(n_bits):
    """Bit counts of every codec's frame and parameter words, and ragged
    ones (the last byte's low bits zero)."""
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (33, n_bits)).astype(np.int32)
    got = native.pack_bits(bits)
    np.testing.assert_array_equal(got, native.pack_bits_reference(bits))
    np.testing.assert_array_equal(got, jnative.pack_bits(bits))
    np.testing.assert_array_equal(native.unpack_bits(got, n_bits), bits)


def test_unpack_matches_numpy():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (8, 23)).astype(np.uint8)
    want = np.unpackbits(packed, axis=1)[:, :184].astype(np.int32)
    for got in (native.unpack_bits(packed, 184), native.unpack_bits_reference(packed, 184),
                jnative.unpack_bits(packed, 184)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.unpack_bits(packed[0], 184), want[:1])
    np.testing.assert_array_equal(native.unpack_bits(packed, 100), want[:, :100])


def test_unpack_rejects_more_bits_than_bytes():
    with pytest.raises(ValueError, match="bytes"):
        native.unpack_bits(np.zeros((2, 3), np.uint8), 25)


def test_interleave():
    rng = np.random.default_rng(2)
    pcm = rng.integers(-32768, 32768, (37, 160)).astype(np.int16)
    got = native.interleave_pcm(pcm)
    assert got.dtype == np.int16 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, pcm.T)
    np.testing.assert_array_equal(got, native.interleave_pcm_reference(pcm))
    np.testing.assert_array_equal(got, jnative.interleave_pcm(pcm))


@pytest.mark.parametrize("idx", [[0, 5, -1, 11], [0, 12, 13, 100, 11, -3],
                                 list(range(-2, 15))], ids=["negative", "high", "sweep"])
def test_scatter(idx):
    """out[f, k] = bits[f, idx[k]], 0 for any index outside [0, n_in)
    (tests/test_native.py's two cases and a sweep over both edges)."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 12)).astype(np.int32)
    idx = np.array(idx, np.int32)
    want = np.where((idx >= 0) & (idx < 12), bits[:, np.clip(idx, 0, 11)], 0)
    got = native.scatter_bits(bits, idx, len(idx))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.scatter_bits_reference(bits, idx, len(idx)))
    np.testing.assert_array_equal(got, jnative.scatter_bits(bits, idx, len(idx)))


def test_scatter_out_of_range_high():
    bits = np.ones((2, 12), np.int32)
    idx = np.array([0, 12, 13, 100, 11, -3], np.int32)
    want = np.tile([1, 0, 0, 0, 1, 0], (2, 1))
    np.testing.assert_array_equal(native.scatter_bits(bits, idx, 6), want)
    np.testing.assert_array_equal(native.scatter_bits_reference(bits, idx, 6), want)


def test_scatter_rejects_n_out_other_than_the_index_length():
    with pytest.raises(ValueError, match="n_out"):
        native.scatter_bits(np.ones((2, 12), np.int32), np.arange(4, dtype=np.int32), 5)
