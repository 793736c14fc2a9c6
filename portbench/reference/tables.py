"""Codec constant tables, read from the frozen copy tables.npz beside this
file (the codec's published tables: Golay and Hamming codebooks, PRNG
tables, quantiser and window tables). The derived packed and bit-matrix
entries are recomputed here.

`T` is the host (numpy) namespace; `table(name, device)` is the same
array as a tensor, one copy per device.
"""

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

NPZ = Path(__file__).resolve().parent / "tables.npz"


def _derived(d):
    """The packed / bit-matrix forms mbe_tpu/tables.py adds on load."""
    cw = d["golay_codewords"].astype(np.int64)
    d["golay_data_packed"] = (
        (cw[:, 11:] << np.arange(12, dtype=np.int64)).sum(axis=1)
    ).astype(np.int32)
    for src, key in (("hamming_codewords_std", "hamming_std_packed"),
                     ("hamming_codewords_7100", "hamming_7100_packed")):
        hw = d[src].astype(np.int64)
        d[key] = (hw << np.arange(15, dtype=np.int64)).sum(axis=1).astype(
            np.int32)
    gg = d["golayGenerator"].astype(np.int64)
    d["golay_Gbits"] = ((gg[:, None] >> np.arange(11)[None, :]) & 1).astype(
        np.int32)
    for name, key in (("hammingGenerator", "hamming_Hbits_std"),
                      ("imbe7100x4400hammingGenerator", "hamming_Hbits_7100")):
        hg = d[name].astype(np.int64)
        d[key] = ((hg[None, :] >> np.arange(15)[:, None]) & 1).astype(np.int32)
    return d


class _Tables:
    """Lazy attribute access to the npz arrays (loaded on first use)."""

    def __init__(self, path: Path):
        self._path = path
        self._data = None

    def _load(self):
        if self._data is None:
            with np.load(self._path) as z:
                self._data = _derived(dict(z))
        return self._data

    def __getattr__(self, name):
        data = self._load()
        if name in data:
            return data[name]
        raise AttributeError(name)

    def keys(self):
        return self._load().keys()


T = _Tables(NPZ)


@lru_cache(maxsize=None)
def table(name: str, device: torch.device) -> torch.Tensor:
    """T.<name> as a tensor on `device` (one cached copy per device)."""
    return torch.from_numpy(np.ascontiguousarray(getattr(T, name))).to(device)
