"""Host-side bit packing and PCM helpers (port of mbe_tpu.native).

The four functions go through ctypes to the C shim native/mbe_host.c,
built as it stands in the repository with the system C compiler into
build/ at first use (ops/cuda/build.py, a library named by a hash of the
source). There is no numpy fallback: a failed build raises with the
compiler's output. The numpy forms `*_reference` beside them give the
same results (the semantics of mbe_tpu.native's fallbacks); the tests hold
the shim against them.
"""

import ctypes

import numpy as np

from .ops.cuda import build

SOURCE = build.ROOT / "native" / "mbe_host.c"
_LIB = None

_P = ctypes.c_void_p
_N = ctypes.c_size_t
_SIGNATURES = {
    "mbe_host_unpack_bits": [_P, _N, _P, _N, _N],
    "mbe_host_pack_bits": [_P, _P, _N, _N, _N],
    "mbe_host_interleave_pcm": [_P, _P, _N, _N],
    "mbe_host_scatter_bits": [_P, _P, _P, _N, _N, _N],
}


def _lib():
    """The shim, built (if its library is not in build/ yet) and loaded
    once per process, with every function's argument types set."""
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE, host=True)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _LIB = lib
    return _LIB


def available() -> bool:
    """True once the shim is loaded in this process (by the first call of
    any of the four functions)."""
    return _LIB is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _frames(packed) -> np.ndarray:
    packed = np.ascontiguousarray(packed, np.uint8)
    return packed[None] if packed.ndim == 1 else packed


def unpack_bits(packed: np.ndarray, n_bits: int) -> np.ndarray:
    """[F, stride_bytes] uint8 packed MSB-first -> [F, n_bits] int32 0/1."""
    packed = _frames(packed)
    f, stride = packed.shape
    if not 0 <= n_bits <= 8 * stride:
        raise ValueError(f"unpack_bits: {n_bits} bits from {stride} bytes per frame")
    out = np.empty((f, n_bits), np.int32)
    _lib().mbe_host_unpack_bits(_ptr(packed), stride, _ptr(out), f, n_bits)
    return out


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[F, n_bits] int32 0/1 -> [F, ceil(n/8)] uint8 MSB-first."""
    bits = np.ascontiguousarray(bits, np.int32)
    f, n = bits.shape
    stride = (n + 7) // 8
    out = np.empty((f, stride), np.uint8)
    _lib().mbe_host_pack_bits(_ptr(bits), _ptr(out), f, n, stride)
    return out


def interleave_pcm(pcm: np.ndarray) -> np.ndarray:
    """[C, S] int16 -> [S, C] int16 interleaved."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    c, s = pcm.shape
    out = np.empty((s, c), np.int16)
    _lib().mbe_host_interleave_pcm(_ptr(pcm), _ptr(out), c, s)
    return out


def scatter_bits(bits: np.ndarray, index: np.ndarray, n_out: int) -> np.ndarray:
    """out[f, k] = bits[f, index[k]], n_out = len(index); an index outside
    [0, n_in) gives 0 (mbe_host_scatter_bits)."""
    bits = np.ascontiguousarray(bits, np.int32)
    index = np.ascontiguousarray(index, np.int32).reshape(-1)
    if n_out != index.size:
        raise ValueError(f"scatter_bits: n_out {n_out} for {index.size} indices")
    f, n_in = bits.shape
    out = np.empty((f, n_out), np.int32)
    _lib().mbe_host_scatter_bits(_ptr(bits), _ptr(index), _ptr(out), f, n_in, n_out)
    return out


def unpack_bits_reference(packed: np.ndarray, n_bits: int) -> np.ndarray:
    """unpack_bits in numpy."""
    return np.unpackbits(_frames(packed), axis=1)[:, :n_bits].astype(np.int32)


def pack_bits_reference(bits: np.ndarray) -> np.ndarray:
    """pack_bits in numpy."""
    bits = np.ascontiguousarray(bits, np.int32)
    return np.packbits(bits.astype(np.uint8), axis=1)[:, :(bits.shape[1] + 7) // 8]


def interleave_pcm_reference(pcm: np.ndarray) -> np.ndarray:
    """interleave_pcm in numpy."""
    return np.ascontiguousarray(np.asarray(pcm, np.int16).T)


def scatter_bits_reference(bits: np.ndarray, index: np.ndarray, n_out: int) -> np.ndarray:
    """scatter_bits in numpy."""
    bits = np.ascontiguousarray(bits, np.int32)
    index = np.asarray(index, np.int32)
    n_in = bits.shape[1]
    out = bits[:, np.clip(index, 0, n_in - 1)]
    out[:, (index < 0) | (index >= n_in)] = 0
    return out
