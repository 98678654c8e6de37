"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``repro_torch/csrc`` is compiled for Hopper (``sm_90a``)
with ``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes``.  The library is built at first use, into ``build/kernels/`` at
the root of the checkout, and named by a hash of the sources, the ``*.cuh``
headers they include and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  The objects compile in parallel, one
``nvcc`` per source.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.  A kernel whose
input is wrong in a way only the data shows (a bound past the table) sets its
device's ``ErrorWord`` instead of making its wrapper synchronize to check
first; the wrapper's caller reads the word after its own next
synchronization.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["ErrorWord", "LaunchCounter", "NVCC_FLAGS", "build", "check", "library", "nvcc"]

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
    # keys (P, C) i64, queries (P, Q) i64, out (P, Q) i32 (written whole),
    # P, C, Q, stream
    "online_lookup_i64": (_P, _P, _P, _I, _I, _I, _P),
    # values (N, F) f32, starts (N,) i32, out (N, F) f32, scratch f64 and its
    # length, error word, N, F, stream
    "rolling_sum_f32": (_P, _P, _P, _P, _L, _P, _L, _I, _P),
    # table_ts (M,) i64, q_ts (B,) i64, q_lo/q_hi (B,) i32, idx (B,) i32,
    # valid (B,) bool, error word, M, B, stream
    "pit_search_i64": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _P),
    # keys/ev/cr (P, C) i64, values (P, C, D) f32, q_keys/q_ev (P, Q) i64,
    # q_values (P, Q, D) f32, scratch i64 and its length, error word,
    # creation, P, C, Q, D, stream
    "merge_scan_i64": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _I, _I, _I, _I, _P),
    # q (B, S, H, D), k/v (B, T, KV, D), out (B, S, H, D), lse (B, H, S) f32
    # or null; B, S, T, H, KV, D, dtype (0 f32, 1 bf16), causal, q strides
    # (b, s, h), k/v strides (b, t, h), stream
    "flash_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _P),
    # the same arguments; bf16 at D 64, 112, 128, 256 on the tensor cores
    "flash_attn_fwd_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _P),
    # q, k, v, lse, dO, dq, dk, dv; (log-sum-exp, delta) scratch f32 (B*H, S
    # rounded up to 128, 2); per-query-head dK, dV scratch f32 (2, B, T, H,
    # D) or null when H == KV; B, S, T, H, KV, D, dtype, causal, q/dO/dq
    # strides (b, s, h), k/v/dk/dv strides (b, t, h), stream
    "flash_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _P),
    # the same arguments; bf16 at D 64, 112, 128, 256 on the tensor cores
    "flash_attn_bwd_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _P),
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


class ErrorWord:
    """32-bit words in pinned host memory, one per device, that a kernel sets
    when its input is wrong (``csrc/errors.cu``): bit i of a word stands for
    ``messages[i]``.  The kernel gets
    ``ptr(device)``, its device's word, allocated at that device's first
    launch; the host reads the word from its own memory, so reading never
    synchronizes.

    The one reliable read is after a synchronization of the device: it sees
    every kernel of that device that finished before it, so a caller reads
    after its own download of the results.  A wrapper also reads its
    device's word before each launch, as a best-effort safety net for a
    report nobody read: what that read sees depends on which earlier kernels
    have finished by then, so the report may surface there or at a later
    call.  ``raise_if_set`` raises ``ValueError`` with the message of the
    lowest bit set and clears the word; a report that a kernel still running
    stores into a word already set is merged into that one raise."""

    def __init__(self, *messages: str) -> None:
        self.messages = messages
        self.message = messages[0]
        self._ptrs: dict[torch.device, int] = {}

    def ptr(self, device: torch.device) -> int:
        """The word of ``device`` (a tensor's device), allocated at its first
        use with ``device`` current."""
        if device not in self._ptrs:
            ptr = library().repro_error_word_alloc()
            if not ptr:
                raise RuntimeError("could not allocate a device-mapped error word")
            self._ptrs[device] = int(ptr)
        return self._ptrs[device]

    def raise_if_set(self, device: torch.device | str | None = None) -> None:
        """Raise if the word of ``device`` (of any device where None) is set,
        clearing it.  A word never allocated reads clear."""
        if device is None:
            keys = list(self._ptrs)
        else:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            keys = [device]
        found = 0
        for key in keys:
            if key in self._ptrs:
                word = ctypes.c_int32.from_address(self._ptrs[key])
                if word.value:
                    found |= word.value
                    word.value = 0
        if found:
            low = (found & -found).bit_length() - 1
            raise ValueError(self.messages[min(low, len(self.messages) - 1)])


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # locates the toolkit

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the sources (if this exact set is not built yet) and return
    the library's path.  Raises with the compiler's output on failure."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + _headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        build_log.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc_bin = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc_bin, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
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
            [nvcc_bin, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp_so)],
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
        lib.repro_error_word_alloc.argtypes = ()
        lib.repro_error_word_alloc.restype = ctypes.c_void_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
