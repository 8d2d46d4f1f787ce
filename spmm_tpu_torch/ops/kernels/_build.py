"""Build, load and count the hand-written CUDA kernels of `csrc/`.

All of `spmm_tpu_torch/csrc/*.cu` is compiled by `nvcc` into one shared
library with a plain C interface, on first use, into `build/spmm_tpu_torch/`
beside the package.  The library's name carries a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the file.  It is
loaded with `ctypes`; every pointer and the stream travel as `c_void_p`
(a default ctypes int would cut a 64-bit pointer to 32 bits).

The lazy build follows `spmm_tpu/ops/kernels/_native_planner.py`.  Nothing
here runs at import time: the CPU tests import every module of the package on
machines without `nvcc`.

`LAUNCHES` counts kernel launches per wrapper.  A wrapper adds one where it
launches its kernel on a CUDA tensor, and nowhere else; the plain PyTorch
versions used for CPU tensors do not count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spmm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"densify_onehot": 0, "extract_roll": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # indptr, indices, data, val, pat, m, k, stream
    "spmm_densify": (_P, _P, _P, _P, _P, _I, ctypes.c_longlong, _P),
    # mask, counts, m, n, stream
    "spmm_extract_count": (_P, _P, _I, _I, _P),
    # c, mask, indptr, col, vals, m, n, cap, stream
    "spmm_extract_compact": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


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
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libspmm_tpu_torch_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
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


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().spmm_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")
