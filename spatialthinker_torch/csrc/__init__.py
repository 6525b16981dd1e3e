"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

The ``.cu`` sources in this directory compile with ``nvcc`` (one process per
source, all started together) and link into one shared library with a plain
C interface, loaded through ``ctypes``. Nothing builds on import:
``library()`` compiles on its first call (seconds) into ``csrc/build/``,
named by a hash of the sources and flags so an edited source rebuilds and an
unchanged one is reused. Each C entry point returns
``cudaGetLastError()`` after its launch; the Python wrappers in
``spatialthinker_torch/ops`` raise when it is nonzero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR / "build"
SOURCES = (
    "flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu", "paged_attention.cu",
    "int4_mlp.cu", "int8_matmul.cu", "silu_quant.cu",
)
# included by the two flash sources, and by the decode, paged, W8A8 and int4 sources; part of the library's hash
HEADERS = ("flash_common.cuh", "hopper_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # q_seg, kv_seg, q_rng, kv_rng, B, Sq, Skv, stream
    "st_flash_ranges": [_P] * 4 + [_I] * 3 + [_P],
    # q, k, v, q_seg, kv_seg, ranges, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, causal_offset, scale,
    # stream
    "st_flash_fwd": [_P] * 8 + [_I] * 8 + [_F, _P],
    # dO, o, q_seg, kv_seg, delta, q_rng, kv_rng, B, Sq, Skv, Hq, D, stream
    "st_flash_bwd_prep": [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, dO, lse, delta, q_seg, kv_seg, q_rng, kv_rng, dq, B, Sq, Skv, Hq, Hkv, D, causal,
    # scale, stream
    "st_flash_bwd_dq": [_P] * 11 + [_I] * 7 + [_F, _P],
    # q, k, v, dO, lse, delta, q_seg, kv_seg, q_rng, kv_rng, dk, dv, part_dk, part_dv,
    # B, Sq, Skv, Hq, Hkv, D, n_split, heads_per_split, causal, scale, stream
    "st_flash_bwd_dkv": [_P] * 14 + [_I] * 9 + [_F, _P],
    # q, k_cache, v_cache, k_scale, v_scale, kv_seg, o, L, B, Hq, Hkv, S, layer, mode,
    # (the plan:) block_rows, n_split, stages, scale, stream
    "st_decode_split": [_P] * 7 + [_I] * 10 + [_F, _P],
    # mode, G, n_split, stages -> bytes of the split kernel's plan (-1: refused)
    "st_decode_split_smem": [_I] * 4,
    # gu, q, s, M, I, row stride, dtype, stream
    "st_silu_quant": [_P] * 3 + [_I] * 2 + [_L, _I, _P],
    # gu, q, s, amax, M, I, row stride, dtype, pass (1: amax, 2: quantize with it), stream
    "st_silu_quant_split": [_P] * 4 + [_I] * 2 + [_L, _I, _I, _P],
    # I -> threads / bytes of dynamic shared memory of a row's CTA
    "st_silu_quant_threads": [_I],
    "st_silu_quant_smem": [_I],
    # q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, o, m, l,
    # stage_k, stage_v, stage_ks, stage_vs, stage_seg,
    # S, Hq, Hkv, page, D, P_max, n_pages, layer, mode, C, (the plan:) n_split, warps, stages,
    # blocks per warp, scale, stream
    "st_paged_attention": [_P] * 15 + [_I] * 14 + [_F, _P],
    # mode, G, page, C, n_split, warps, stages, blocks per warp -> bytes of the mode's plan (-1: refused)
    "st_paged_split_smem": [_I] * 8,
    # x, scratch, q4, gscale, out, m, k, n_cols, group, gateup, out_f32, (the plan:) warps, ranks,
    # stages, tile_rows, stream
    "st_int4_mlp": [_P] * 5 + [_I] * 10 + [_P],
    # x, amax, scratch, q4, gscale, out, m, kx, k, n_cols, group, (the plan:) warps, ranks, stages,
    # tile_rows, stream
    "st_int4_mlp_split": [_P] * 6 + [_I] * 9 + [_P],
    # x, x_f32, xq, xs, w, ws, out, out_f32, m, n, k, quantize, mb, bn, splits, stages, stream
    "st_int8_matmul": [_P, _I] + [_P] * 5 + [_I] * 9 + [_P],
    # x, x_f32, xq, xs, amax, m, k, pass (1: amax, 2: quantize with it), stream
    "st_quantize_rows_split": [_P, _I] + [_P] * 3 + [_I] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    # names of this build's own: ranks (or hosts sharing the directory) that
    # build at once never touch each other's objects or link output
    stem = f"{out.stem}.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    objects = [BUILD_DIR / f"{stem}.{Path(name).stem}.o" for name in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
             "-c", "-o", str(obj), str(CSRC_DIR / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for name, obj in zip(SOURCES, objects)
    ]
    outputs = [proc.communicate() for proc in procs]  # all compile concurrently
    try:
        for name, proc, (_, stderr) in zip(SOURCES, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):\n{stderr}")
            if verbose:
                print(stderr, flush=True)
        tmp = out.with_name(f"{stem}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
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


def refuse_sharded(**tensors) -> None:
    """Raise, by argument name, for a sharded tensor (a ``DTensor``): the
    kernels read ``data_ptr()`` of one device's memory, which for a DTensor
    is one rank's shard only -- the caller must pass whole tensors."""
    from torch.distributed.tensor import DTensor

    for name, t in tensors.items():
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a sharded DTensor; the CUDA kernels take whole tensors "
                            "(gather it first, e.g. parallel.sharding.unsharded_copy)")


def check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
