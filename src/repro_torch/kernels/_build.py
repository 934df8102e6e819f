"""Build and load the port's CUDA kernels at first use.

Each source under ``csrc/`` (``routing.cu``, ``attention.cu``,
``ssd.cu``) is compiled by ``nvcc`` into a shared library of its own
with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). A library lands in ``build/torch_kernels/`` at the
repository root, named by a hash of its source and flags, so an edited
source never loads a stale build. :func:`build_all` starts one ``nvcc``
per source, all at once. Nothing here runs at import: the CPU tests
import every module, and a machine without a card may have no ``nvcc``.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"routing": CSRC / "routing.cu", "attention": CSRC / "attention.cu",
           "ssd": CSRC / "ssd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

# -fmad=false: the kernels pin the rounding of every step (no fused
# multiply-add unless a kernel asks for one with __fmaf_rn); -prec-div /
# -prec-sqrt keep IEEE division. Never --use_fast_math: __expf/__logf
# are far less accurate than expf/logf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-Xptxas", "-v",
)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


# launcher name -> argument types, per library; every launcher returns
# the cudaError_t of its launch as an int
SIGNATURES = {
    "routing": {
        "laimr_routing_score": (
            [_VOIDP, _INT, _INT] + [_VOIDP] * 7 + [_INT] + [_VOIDP] * 2
            + [_INT] * 3 + [_VOIDP] * 4),
        "laimr_routing_guard": (
            [_VOIDP, _INT, _INT] + [_VOIDP] * 10 + [_INT] * 2
            + [_VOIDP] * 4),
        "laimr_routing_topk": (
            [_VOIDP, _INT, _INT] + [_VOIDP] * 7 + [_INT] + [_VOIDP] * 2
            + [_INT] * 4 + [_FLOAT] + [_VOIDP] * 4),
        "laimr_routing_attain": (
            [_VOIDP, _INT, _INT] + [_VOIDP] * 7 + [_INT] + [_VOIDP] * 3
            + [_INT] * 4 + [_FLOAT] + [_VOIDP] * 4),
    },
    "attention": {
        # q, k, v, out, dtype, B, Sq, Skv, H, Hkv, D, scale, causal,
        # window, softcap, stream
        "laimr_flash_attention": (
            [_VOIDP] * 4 + [_INT] * 7 + [_FLOAT, _INT, _INT, _FLOAT]
            + [_VOIDP]),
        # q, k_cache, v_cache, kv_pos, q_pos, out, dtype, B, C, H, Hkv, D,
        # scale, window, softcap, stream
        "laimr_decode_attention": (
            [_VOIDP] * 6 + [_INT] * 6 + [_FLOAT, _INT, _FLOAT] + [_VOIDP]),
    },
    "ssd": {
        # x, dt, a, b, c, d_skip, h0 (or null), y, h_final, dtype, B, L,
        # H, P, G, N, stream
        "laimr_ssd_scan": [_VOIDP] * 9 + [_INT] * 7 + [_VOIDP],
    },
}
ERROR_STRING = {"routing": "laimr_cuda_error_string",
                "attention": "laimr_attention_error_string",
                "ssd": "laimr_ssd_error_string"}


class KernelLibrary:
    """One loaded kernel library plus how it was built."""

    def __init__(self, name: str, path: Path, seconds: float, log: str):
        self.name = name
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).restype = _INT
            getattr(lib, fn).argtypes = argtypes
        self._error_string = getattr(lib, ERROR_STRING[name])
        self._error_string.restype = ctypes.c_char_p
        self._error_string.argtypes = [_INT]
        self.lib = lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launcher reported a CUDA error."""
        if rc != 0:
            msg = self._error_string(rc).decode()
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


def _target(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=tuple(SOURCES)) -> dict[str, tuple[Path, float, str]]:
    """Compile every library in ``names`` that this source/flag pair has
    not built yet, one ``nvcc`` per source, all started together.
    Returns name -> (path, seconds spent, compiler output); seconds is 0
    and the output empty for a library that was built already."""
    targets = {name: _target(name) for name in names}
    out = {name: (t, 0.0, "") for name, t in targets.items() if t.is_file()}
    pending = [name for name in names if name not in out]
    if pending:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in pending:
        target = targets[name]
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name].name} failed "
                          f"({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = (target, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str = "routing") -> tuple[Path, float, str]:
    """Compile one library unless it was built already."""
    return build_all((name,))[name]


@functools.cache
def library(name: str = "routing") -> KernelLibrary:
    """The kernels of ``csrc/<name>.cu``, built and loaded on first
    call."""
    return KernelLibrary(name, *build(name))
