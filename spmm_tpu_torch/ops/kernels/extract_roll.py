"""Dense product under a structural mask -> CSR, kept cells in row-major
order.

Port of `spmm_tpu/ops/kernels/extract_roll.py::extract_roll`, and with it of
every extraction route of `spmm_tpu/ops/spgemm.py` (`_extract_full`,
`_extract_shift`, `_extract_sort`): all four give the same output, so one
kernel serves every hole count.  On a CUDA tensor the wrapper launches
`csrc/extract.cu` (per-row counts, an int32 scan, per-row ballot
compaction); on a CPU tensor it runs `extract_roll_plain`.

`cap` is the length of the returned `col`/`vals`: slots past the kept
count are zero, and kept cells past `cap` are dropped.  `indptr` is not
clamped (the caller clamps, as `_alg1_fixed` does).  The JAX function's
`g_pad` bucket only sizes its roll plan and has no counterpart here.
Bound on the card: bytes (the mask is read twice, kept values once).
"""

from __future__ import annotations

from typing import Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build


def _indptr(counts: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(1, dtype=prim.INDEX_DTYPE, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, 0, dtype=prim.INDEX_DTYPE)])


def extract_roll_plain(c: torch.Tensor, mask: torch.Tensor, cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device."""
    n = c.shape[1]
    indptr = _indptr(mask.sum(1, dtype=prim.INDEX_DTYPE))
    flat = torch.nonzero(mask.reshape(-1)).squeeze(1)[:cap]
    col = torch.zeros(cap, dtype=prim.INDEX_DTYPE, device=c.device)
    vals = torch.zeros(cap, dtype=c.dtype, device=c.device)
    col[:flat.numel()] = (flat % n).to(prim.INDEX_DTYPE)
    vals[:flat.numel()] = c.reshape(-1)[flat]
    return indptr, col, vals


def _check(c: torch.Tensor, mask: torch.Tensor, cap: int) -> None:
    if c.dtype != torch.float32 or c.dim() != 2 or not c.is_contiguous():
        raise ValueError(f"extract_roll: c must be a contiguous 2-D float32 "
                         f"tensor, got {c.dtype} {tuple(c.shape)}")
    if (mask.dtype != torch.bool or mask.shape != c.shape
            or not mask.is_contiguous()):
        raise ValueError(f"extract_roll: mask must be a contiguous bool "
                         f"tensor of shape {tuple(c.shape)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != c.device:
        raise ValueError(f"extract_roll: mask is on {mask.device}, c on "
                         f"{c.device}")
    if cap < 0:
        raise ValueError(f"extract_roll: negative cap {cap}")
    if c.numel() >= 2**31:
        raise ValueError(f"extract_roll: {tuple(c.shape)} has more cells "
                         "than an int32 indptr can count")


def extract_roll(c: torch.Tensor, mask: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSR (indptr, col, vals) of the kept cells of dense `c` under `mask`,
    in row-major order, with `col`/`vals` of length `cap`."""
    _check(c, mask, cap)
    if c.device.type == "cpu":
        return extract_roll_plain(c, mask, cap)
    if c.device.type != "cuda":
        raise ValueError(f"extract_roll: unsupported device {c.device}")
    m, n = c.shape
    col = torch.zeros(cap, dtype=prim.INDEX_DTYPE, device=c.device)
    vals = torch.zeros(cap, dtype=c.dtype, device=c.device)
    if m == 0 or n == 0:
        # a zero-size grid is a launch error; nothing is kept
        return (torch.zeros(m + 1, dtype=prim.INDEX_DTYPE, device=c.device),
                col, vals)
    counts = torch.empty(m, dtype=prim.INDEX_DTYPE, device=c.device)
    lib = _build.library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.spmm_extract_count(mask.data_ptr(), counts.data_ptr(),
                                            m, n, stream), "extract_roll")
        indptr = _indptr(counts)
        _build.check(lib.spmm_extract_compact(
            c.data_ptr(), mask.data_ptr(), indptr.data_ptr(), col.data_ptr(),
            vals.data_ptr(), m, n, cap, stream), "extract_roll")
    _build.LAUNCHES["extract_roll"] += 1
    return indptr, col, vals
