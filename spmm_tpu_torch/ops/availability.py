"""Op availability table, the `cupyx.cusparse.check_availability` analogue.

Port of `spmm_tpu/ops/availability.py`, keyed by torch device type.  Every
op JAX marks available on cpu/tpu/gpu runs on `"cpu"` and `"cuda"` here;
its fast path (a hand-written kernel of `csrc/`) is `"cuda"` where JAX's
is `"tpu"`.  `bsr_spmm_pallas` (the kernel `bsr_spmm`) runs on both, its
plain version on the CPU.  The legacy cuSPARSE names `csrmv` and `csrmm2`
stay unavailable everywhere, as on CUDA >= 11 in the reference
(cusparse.py:82-85).
"""

from __future__ import annotations

import torch

_BOTH = frozenset({"cpu", "cuda"})
_CARD = frozenset({"cuda"})
_NONE = frozenset()

# op -> (available device types, fast-path device types)
_AVAILABILITY = {
    "spmv": (_BOTH, _CARD),
    "spmm": (_BOTH, _CARD),
    "spgemm": (_BOTH, _CARD),
    "spgemm_fixed": (_BOTH, _CARD),
    "sddmm": (_BOTH, _CARD),
    "bsr_spmm_pallas": (_BOTH, _CARD),
    "csrsort": (_BOTH, _NONE),
    "coosort": (_BOTH, _NONE),
    "coo2csr": (_BOTH, _NONE),
    "csr2csc": (_BOTH, _NONE),
    "denseToSparse": (_BOTH, _NONE),
    "sparseToDense": (_BOTH, _NONE),
    "csrmv": (_NONE, _NONE),
    "csrmm2": (_NONE, _NONE),
}


def _entry(name: str, backend):
    if name not in _AVAILABILITY:
        raise KeyError(f"unknown op {name!r}")
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    return _AVAILABILITY[name], backend


def check_availability(name: str, backend: str | None = None) -> bool:
    """True iff op `name` is available on device type `backend` (default:
    "cuda" where a card is present, else "cpu")."""
    (available, _), backend = _entry(name, backend)
    return backend in available


def has_fast_path(name: str, backend: str | None = None) -> bool:
    """True iff op `name` runs a hand-written kernel on `backend`."""
    (_, fast), backend = _entry(name, backend)
    return backend in fast
