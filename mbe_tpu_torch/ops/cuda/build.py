"""Build a source at first use, load it with ctypes, and launch and count
its entry points.

Each source under mbe_tpu_torch/csrc/ has a plain C interface. It is
compiled with nvcc for sm_90a into build/ at the repository root, into a
library named by a hash of the source, so an edited source builds anew and
an unchanged one is reused. A host source (the C shim native/mbe_host.c)
takes the same route with the system C compiler.

Every C entry point of a kernel is declared once, as a `Kernel` passed to
`register`; KERNELS lists them in declaration order. A binding under
ops/cuda/ checks its tensors with `check`, allocates its outputs and calls
`Kernel.launch`, or `Kernel.gate` when it has no work: either raises for
any device but CUDA. The one caller of each binding sends CPU tensors to
the plain form instead.

LAUNCHES (`counts`, `zero`) holds one launch count per kernel library (the
three entry points of sources.cu share one; the marks have none). The
plain forms do not count. A replay of a CUDA graph runs no Python:
utils/graphs.Captured adds the launches seen during its capture to these
counts on every replay.
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-fvisibility=hidden")
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


class Count:
    """The launches of one kernel library."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0


# the launch count of each kernel library, by name
LAUNCHES: dict[str, Count] = {}
# every registered entry point, in declaration order
KERNELS: list["Kernel"] = []
# the loaded library of each source
_LIBS: dict[Path, ctypes.CDLL] = {}


@dataclasses.dataclass(eq=False)
class Kernel:
    """One C entry point of a CUDA source. It returns a CUDA error code (0
    when the launch was accepted) and takes the stream last.

    counter: the name of its library's count in LAUNCHES; None for none.
    argtypes: its parameters' ctypes, the stream's included.
    on_load: None, or a check of the library, run once before the entry
      point is first used.
    """

    counter: str | None
    source: Path
    symbol: str
    argtypes: list
    on_load: Callable[[ctypes.CDLL], None] | None
    _fn: Callable | None = dataclasses.field(default=None, init=False, repr=False)

    def load(self):
        """Build (if needed) and load the source's library, once per
        source; returns the entry point with its argument types set."""
        if self._fn is None:
            lib = _LIBS.get(self.source)
            if lib is None:
                lib = _LIBS[self.source] = load(self.source)
            if self.on_load is not None:
                self.on_load(lib)
            fn = self._fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
        return self._fn

    def gate(self, device: torch.device):
        """Raise ValueError for any device but CUDA."""
        if device.type != "cuda":
            raise ValueError(f"{self.symbol}: no kernel for device {device}")

    def launch(self, device: torch.device, *args):
        """Call the entry point with `args` (a tensor as its data pointer)
        and the current stream of `device`, under that device; count the
        launch. Any device but CUDA raises ValueError (`gate`), a CUDA error
        RuntimeError."""
        self.gate(device)
        fn = self.load()
        with torch.cuda.device(device):
            err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                     torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed, CUDA error {err}")
        if self.counter is not None:
            LAUNCHES[self.counter].n += 1


def register(kernel: Kernel) -> Kernel:
    """Add `kernel` to KERNELS, and its counter, if new, to LAUNCHES."""
    KERNELS.append(kernel)
    if kernel.counter is not None:
        LAUNCHES.setdefault(kernel.counter, Count())
    return kernel


def counts() -> dict[str, int]:
    """Every library's launch count, by name."""
    return {name: count.n for name, count in LAUNCHES.items()}


def zero():
    """Set every library's launch count to 0."""
    for count in LAUNCHES.values():
        count.n = 0


def check(entry: str, args) -> torch.device:
    """Each (name, tensor, dtype, shape) of `args`: its dtype, shape and
    contiguity, and one device for all, which is returned; `entry` names
    the caller in the ValueError."""
    device = args[0][1].device
    for name, x, dtype, shape in args:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{entry}: {name} must be {dtype} of shape {shape}, "
                             f"got {x.dtype} of shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{entry}: {name} is on {x.device}, not {device}")
    return device
