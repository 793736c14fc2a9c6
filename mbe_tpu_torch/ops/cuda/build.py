"""Build a kernel source with nvcc at first use and load it with ctypes.

Each source under mbe_tpu_torch/csrc/ has a plain C interface. It is
compiled for sm_90a into build/ at the repository root, into a library
named by a hash of the source, so an edited source builds anew and an
unchanged one is reused.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's kernels are built from "
                           f"{CSRC} at first use")
    return nvcc


def load(source: Path) -> ctypes.CDLL:
    """Build `source` (if its library is not in build/ yet) and load it."""
    src = source.read_bytes()
    lib_path = BUILD_DIR / f"{source.stem}_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
