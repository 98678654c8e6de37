"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``repro_torch/csrc`` is compiled for Hopper (``sm_90a``)
with ``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes``.  The library is built at first use, into ``build/kernels/`` at
the root of the checkout, and named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
objects compile in parallel, one ``nvcc`` per source.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["LaunchCounter", "NVCC_FLAGS", "build", "check", "library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry -> argtypes; every entry returns a cudaError_t as int
_SIGNATURES = {
    # keys (P, C) i64, queries (P, Q) i64, out (P, Q) i32, P, C, Q, stream
    "online_lookup_i64": (_P, _P, _P, _I, _I, _I, _P),
    # values (N, F) f32, starts (N,) i32, out (N, F) f32, N, F, stream
    "rolling_sum_f32": (_P, _P, _P, _L, _I, _P),
}

_lib: ctypes.CDLL | None = None
build_log: dict = {}


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches it,
    and nowhere else, so a run can show which path went through the card."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0

    def add(self) -> None:
        self.launches += 1

    def reset(self) -> None:
        self.launches = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # locates the toolkit

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the sources (if this exact set is not built yet) and return
    the library's path.  Raises with the compiler's output on failure."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        build_log.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                        q.wait()
                raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_log.update(path=str(so), seconds=time.perf_counter() - t0, cached=False)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
