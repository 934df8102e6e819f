"""Build and load the port's CUDA kernels at first use.

``csrc/routing.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library lands in ``build/torch_kernels/`` at
the repository root, named by a hash of its source and flags, so an
edited source never loads a stale build. Nothing here runs at import:
the CPU tests import every module, and a machine without a card may
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "routing.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

# -fmad=false: the kernels pin the rounding of every step (no fused
# multiply-add); -prec-div / -prec-sqrt keep IEEE division. Never
# --use_fast_math: __expf/__logf are far less accurate than expf/logf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-Xptxas", "-v",
)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


class KernelLibrary:
    """The loaded routing library plus how it was built."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        lib = ctypes.CDLL(str(path))
        lib.laimr_routing_score.restype = _INT
        lib.laimr_routing_score.argtypes = (
            [_VOIDP, _INT, _INT] + [_VOIDP] * 7 + [_INT] + [_VOIDP] * 2
            + [_INT] * 3 + [_VOIDP] * 4)
        lib.laimr_routing_guard.restype = _INT
        lib.laimr_routing_guard.argtypes = (
            [_VOIDP, _INT, _INT] + [_VOIDP] * 10 + [_INT] * 2
            + [_VOIDP] * 4)
        lib.laimr_cuda_error_string.restype = ctypes.c_char_p
        lib.laimr_cuda_error_string.argtypes = [_INT]
        self.lib = lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launcher reported a CUDA error."""
        if rc != 0:
            msg = self.lib.laimr_cuda_error_string(rc).decode()
            raise RuntimeError(f"{what}: kernel launch failed with CUDA "
                               f"error {rc} ({msg})")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def build() -> tuple[Path, float, str]:
    """Compile the routing library unless this source/flag pair was
    built already. Returns (path, seconds spent, compiler output)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"librouting_{digest[:16]}.so"
    if out.is_file():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, seconds, log


@functools.cache
def library() -> KernelLibrary:
    """The routing kernels, built and loaded on first call."""
    return KernelLibrary(*build())
