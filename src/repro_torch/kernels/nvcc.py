"""Build a kernel's CUDA source with `nvcc` at first use and load it.

Each kernel module holds one `KernelLibrary`: a `.cu` file with a plain C
interface, compiled into ``build/repro_torch_kernels/<hash>/lib<name>.so``
under the checkout (the hash covers the source, the shared headers
``csrc/*.cuh`` and the flags) and loaded with `ctypes`.  Nothing is
compiled while a module is imported: the first launch builds, or a
caller builds several libraries at once with `build_all`, one `nvcc`
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
# Hopper target and a shared library with a plain C interface; each
# kernel adds its own numeric flags
BASE_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source on the machine with the card")
    return path


class KernelLibrary:
    """One CUDA source, its flags, its built library and its ctypes
    handle.  `info` records the build's seconds, whether it was cached,
    and the compiler's register/shared-memory report (kept beside the
    library, so a cached build still has it)."""

    def __init__(self, name: str, source: str, flags: tuple, bind):
        self.name = name
        self.source = CSRC / source
        self.flags = BASE_FLAGS + tuple(flags)
        self._bind = bind            # sets argtypes/restype on the CDLL
        self._proc = None
        self._lib = None
        self.info: dict = {}

    def _paths(self):
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(self.source.read_bytes() + headers
                             + " ".join(self.flags).encode()).hexdigest()
        out = BUILD_ROOT / key[:16] / f"lib{self.name}.so"
        return out, out.parent / f".{self.name}.{os.getpid()}.tmp.so"

    def start(self) -> None:
        """Start `nvcc` in the background unless the library is built."""
        out, tmp = self._paths()
        if self._proc is not None or out.is_file():
            return
        out.parent.mkdir(parents=True, exist_ok=True)
        self._log = tempfile.TemporaryFile(mode="w+")
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
            stdout=self._log, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> pathlib.Path:
        """Finish the build `start` began; returns the library's path."""
        out, tmp = self._paths()
        if self._proc is None:
            if not out.is_file():
                raise RuntimeError(f"{self.name}: build was not started")
            if not self.info:
                log = out.with_suffix(".log")
                self.info = dict(path=str(out), seconds=0.0, cached=True,
                                 log=log.read_text() if log.is_file() else "")
            return out
        rc = self._proc.wait()
        self._log.seek(0)
        log = self._log.read()
        self._log.close()
        self._proc = None
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({rc}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        self.info = dict(path=str(out), cached=False, log=log,
                         seconds=time.perf_counter() - self._t0)
        return out

    def build(self) -> pathlib.Path:
        self.start()
        return self.wait()

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Build several kernel libraries with one `nvcc` each, in parallel."""
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.wait()
