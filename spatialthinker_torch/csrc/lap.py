"""The Jonker-Volgenant linear assignment solver (``lap.cpp``) through ctypes.

Counterpart of the ``lap`` object of ``spatialthinker_tpu/csrc/__init__.py``,
with the same ``solve`` contract (scipy's ``linear_sum_assignment``:
``(row_ind, col_ind)``, ``min(nr, nc)`` pairs, rows sorted). The source
builds at first use with ``g++`` into ``csrc/build/`` (named by a hash of the
source and flags, so an edited source rebuilds), host code only: it never
starts the CUDA kernels' build. A failed build or solve raises with the
compiler's output; nothing falls back to scipy, which the tests hold the
solver against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR / "build"
SOURCE = CSRC_DIR / "lap.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblap_{digest}.so"


def build() -> Path:
    """Compile ``lap.cpp`` unless an up-to-date library exists; returns its
    path. Raises RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found (needed to build the assignment solver csrc/lap.cpp)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this build's own: processes that build at once never share an output
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    done = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {done.returncode}):\n{done.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded solver (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lap_solve.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
            lib.lap_solve.restype = ctypes.c_int
            _lib = lib
    return _lib


def solve(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment of a 2-D cost matrix; returns (row_ind,
    col_ind) like scipy's ``linear_sum_assignment`` (len = min(nr, nc),
    rows sorted)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    if cost.ndim != 2:
        raise ValueError(f"the cost matrix must be 2-D, got shape {cost.shape}")
    nr, nc = cost.shape
    out = np.full(nr, -1, dtype=np.int32)
    rc = library().lap_solve(cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nr, nc,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise RuntimeError(f"lap_solve failed with code {rc}")
    rows = np.nonzero(out >= 0)[0]
    return rows.astype(np.int64), out[rows].astype(np.int64)
