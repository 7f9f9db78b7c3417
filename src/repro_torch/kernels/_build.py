"""Builds the port's CUDA sources on first use and loads them with ctypes.

Each source under ``repro_torch/csrc/`` is compiled by one ``nvcc`` call for
``sm_90a`` into a shared library with a plain C interface (no PyTorch headers,
so a build takes seconds), cached under ``build/repro_torch/`` at the root of
the checkout by a hash of the source and the flags. :func:`build_all` starts
every compiler at once and waits for all of them. A failed build raises:
nothing runs without its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.obs.counters import count_compile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on a machine with the CUDA toolkit")
    return str(path)


class CudaKernel:
    """One CUDA source, its C launch function and its launch count.

    ``launches`` grows by one each time a wrapper launches the kernel (and
    nowhere else), so a run can show that its main path went through it.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.ptxas_log = ""
        self._fn = None
        self._lib = None

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` unless the library is built; returns the process."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        log_path = self.library.with_suffix(".log")
        if proc is not None:
            out, _ = proc.communicate()
            tmp = Path(proc.args[proc.args.index("-o") + 1])
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"(exit {proc.returncode}):\n{out}")
            log_path.write_text(out)
            os.replace(tmp, self.library)
        self.ptxas_log = log_path.read_text() if log_path.exists() else ""

    def function(self):
        """The C launch function, building the library on first use; the
        first load counts as one compile (``obs.counters``)."""
        if self._fn is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.library))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(self._lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._error_string = err
            self._fn = fn
            count_compile()
        return self._fn

    def query(self, symbol: str, argtypes: Sequence, *args) -> None:
        """Call another C function of the library (one that launches
        nothing) and raise on a CUDA error; the launch count is untouched."""
        self.function()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        code = fn(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.name} {symbol} failed: CUDA error "
                               f"{code} ({msg})")

    def launch(self, *args) -> None:
        """Call the C launch function and raise on any CUDA error."""
        code = self.function()(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{code} ({msg})")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every kernel's library, all compilers running at once."""
    procs = [k.start_build() for k in kernels]
    for k, p in zip(kernels, procs):
        k.finish_build(p)
    for k in kernels:
        k.function()
