"""Build, load and count the hand-written CUDA kernels of `csrc/`.

Each `spmm_tpu_torch/csrc/*.cu` is compiled by its own `nvcc`, all started
together, and the objects are linked into one shared library with a plain C
interface, on first use, into `build/spmm_tpu_torch/` beside the package.
The library's name carries a hash of the sources, headers and flags, so an
edit rebuilds and an unchanged tree reuses the file.  It is
loaded with `ctypes`; every pointer and the stream travel as `c_void_p`
(a default ctypes int would cut a 64-bit pointer to 32 bits).

The lazy build follows `spmm_tpu/ops/kernels/_native_planner.py`.  Nothing
here runs at import time: the CPU tests import every module of the package on
machines without `nvcc`.

`LAUNCHES` counts kernel launches per wrapper.  A wrapper adds one where it
launches its kernel on a CUDA tensor, and nowhere else; the plain PyTorch
versions used for CPU tensors do not count.  `launch` calls a kernel on the
current stream, entering a device guard only where the tensors lie on
another device than the current one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spmm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# what `ptxas -v` said of each kernel (registers, spills) at the last build
PTXAS_REPORT = []

LAUNCHES = {"densify_onehot": 0, "densify_onehot_pattern": 0,
            "extract_roll": 0, "spmv_binned": 0,
            "spmv_routed": 0, "spmm_routed": 0, "spmv_onehot": 0,
            "expand_routed": 0, "compress_routed": 0, "bsr_spmm": 0,
            "csr_densify_mxu": 0, "segment_sum": 0, "spmv_binned_plan": 0,
            "esc_count": 0, "esc_compress": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # indptr, indices, data, val, pat, m, k, width, stream
    "spmm_densify": (_P, _P, _P, _P, _P, _I, _L, _I, _P),
    # indptr, indices, pat, m, k, stream
    "spmm_densify_pattern": (_P, _P, _P, _I, _L, _P),
    # c, mask, ws, indptr, col, vals, m, n, cap, tile_cells, width, stream
    "spmm_extract_roll": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # indptr, indices, data, x, rows, class_off, piece_end, piece_row,
    # counters, partial, y, m, max_units, stream
    "spmm_spmv_binned": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _P),
    # slice_ptr, slice_rows, sell_col, sell_val, n8, n4, n2, n1,
    # indices, data, chunk_start, chunk_end, chunk_row, nchunks,
    # long_rows, long_chunk_ptr, x, counters, partial, y, stream
    "spmm_spmv_routed": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                         _I, _P, _P, _P, _P, _P, _P, _P),
    # indptr, indices, data, order, nrows, cut, chunk_start, chunk_end,
    # chunk_row, chunk_order, nchunks, long_rows, long_chunk_ptr, counters,
    # x, k, partial, y, stream
    "spmm_spmm_routed": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                         _P, _P, _P, _P, _I, _P, _P, _P),
    # indptr, m, ntiles, tile_stats, rows, class_off, piece_end, piece_row,
    # counters, stream
    "spmm_spmv_binned_plan": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # indptr, indices, data, x, row_s, own, nchunks, ch, nnz, counters,
    # carry, y, stream
    "spmm_spmv_onehot": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P, _P, _P, _P),
    # values, starts, lengths, nseg, width, dtype, out, stream
    "spmm_segment_sum": (_P, _P, _P, _L, _I, _I, _P, _P),
    # vals, pos, src, win, val, pat, cells, window, stream
    "spmm_expand_routed": (_P, _P, _P, _P, _P, _P, _L, _I, _P),
    # c, pos, wide (int64 pos), prev, out, cap, alpha, beta, stream
    "spmm_compress_routed": (_P, _P, _I, _P, _P, _L, _F, _F, _P),
    # indptr, indices, blocks, b, out, mb, R, C, m, K, N, stream
    "spmm_bsr_spmm": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P),
    # the same and dtype
    "spmm_bsr_spmm_wide": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I,
                           _P),
    # indptr, indices, data, out, m, k, stream
    "spmm_densify_mxu": (_P, _P, _P, _P, _I, _I, _P),
    # row, col, P, count, stream
    "spmm_esc_count": (_P, _P, _I, _P, _P),
    # row, col, val, P, alpha_re, alpha_im, indptr, row_lo, nrows,
    # base_out, col_out, val_out, nnz, ws, dtype, stream
    "spmm_esc_compress": (_P, _P, _P, _I, _D, _D, _P, _I, _I, _I, _P, _P,
                          _I, _P, _I, _P),
}
# the routed SpMV over a float64 plan takes the float32 entry's arguments
_SIGNATURES["spmm_spmv_routed_f64"] = _SIGNATURES["spmm_spmv_routed"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def build() -> Path:
    """Compile `csrc/*.cu` into the build directory unless an identical
    build is already there; return the library's path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + _headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"libspmm_tpu_torch_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # one nvcc per source, all started together, then one link
    objs = [BUILD_DIR / f"{s.stem}_{tag}.{os.getpid()}.o" for s in srcs]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          str(o), str(s)] for s, o in zip(srcs, objs))]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        PTXAS_REPORT.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: no process sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spmm_error_string.argtypes = (ctypes.c_int,)
    lib.spmm_error_string.restype = ctypes.c_char_p
    return lib


def launch(index: int, name: str, *args) -> int:
    """Call the library's `name` with `args` and the current stream of CUDA
    device `index`; returns its error code."""
    fn = getattr(library(), name)
    stream = torch._C._cuda_getCurrentRawStream(index)  # the raw handle
    if index == torch._C._cuda_getDevice():  # the current device
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().spmm_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")
