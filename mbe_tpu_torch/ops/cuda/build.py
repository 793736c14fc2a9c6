"""Build a source at first use and load it with ctypes.

Each source under mbe_tpu_torch/csrc/ has a plain C interface. It is
compiled with nvcc for sm_90a into build/ at the repository root, into a
library named by a hash of the source, so an edited source builds anew and
an unchanged one is reused. A host source (the C shim native/mbe_host.c)
takes the same route with the system C compiler.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-fvisibility=hidden")


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's kernels are built from "
                           f"{CSRC} at first use")
    return nvcc


def _cc():
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) found: the host shim is built from "
                           f"{ROOT / 'native'} at first use")
    return cc


def load(source: Path, host: bool = False) -> ctypes.CDLL:
    """Build `source` (if its library is not in build/ yet) and load it:
    with nvcc, or with the system C compiler when `host`."""
    src = source.read_bytes()
    lib_path = BUILD_DIR / f"{source.stem}_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        compiler = [_cc(), *CC_FLAGS] if host else [_nvcc(), *NVCC_FLAGS]
        proc = subprocess.run([*compiler, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler[0]} failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
