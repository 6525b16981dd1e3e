"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

The ``.cu`` sources in this directory compile with ``nvcc`` into one shared
library with a plain C interface, loaded through ``ctypes``. Nothing builds
on import: ``library()`` compiles on its first call (seconds) into
``csrc/build/``, named by a hash of the sources and flags so an edited
source rebuilds and an unchanged one is reused. Each C entry point returns
``cudaGetLastError()`` after its launch; the Python wrappers in
``spatialthinker_torch/ops`` raise when it is nonzero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR / "build"
SOURCES = ("flash_attention.cu", "decode_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, q_seg, kv_seg, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, causal_offset, scale, stream
    "st_flash_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
    # q, k_cache, v_cache, kv_seg, o, B, Hq, Hkv, S, D, layer, scale, stream
    "st_decode_attention": [_P] * 5 + [_I] * 6 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libst_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless an up-to-date library exists; returns its
    path. ``verbose`` adds ``-Xptxas -v`` and prints its register and
    shared-memory report."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
