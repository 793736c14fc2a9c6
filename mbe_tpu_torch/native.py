"""Host-side bit packing and PCM helpers in numpy (port of mbe_tpu.native,
with the semantics of its numpy fallbacks; the results equal those of the
native shim native/mbe_host.c)."""

import numpy as np


def unpack_bits(packed: np.ndarray, n_bits: int) -> np.ndarray:
    """[F, stride_bytes] uint8 packed MSB-first -> [F, n_bits] int32 0/1."""
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.ndim == 1:
        packed = packed[None]
    return np.unpackbits(packed, axis=1)[:, :n_bits].astype(np.int32)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[F, n_bits] int 0/1 -> [F, ceil(n/8)] uint8 MSB-first."""
    bits = np.ascontiguousarray(bits, np.int32)
    return np.packbits(bits.astype(np.uint8), axis=1)[:, :(bits.shape[1] + 7) // 8]


def interleave_pcm(pcm: np.ndarray) -> np.ndarray:
    """[C, S] int16 -> [S, C] int16 interleaved."""
    return np.ascontiguousarray(np.asarray(pcm, np.int16).T)


def scatter_bits(bits: np.ndarray, index: np.ndarray, n_out: int) -> np.ndarray:
    """out[f, k] = bits[f, index[k]], n_out = len(index); an index outside
    [0, n_in) gives 0 (mbe_host_scatter_bits)."""
    bits = np.ascontiguousarray(bits, np.int32)
    index = np.asarray(index, np.int32)
    n_in = bits.shape[1]
    out = bits[:, np.clip(index, 0, n_in - 1)]
    out[:, (index < 0) | (index >= n_in)] = 0
    return out
