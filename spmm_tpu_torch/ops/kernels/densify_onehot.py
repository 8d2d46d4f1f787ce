"""Canonical CSR -> dense values + bf16 structural 0/1 pattern, or the
pattern alone.

Port of `spmm_tpu/ops/kernels/densify_onehot.py::densify_onehot` and
`::densify_onehot_pattern`.  On a CUDA tensor each wrapper launches its
hand-written kernel in `csrc/densify.cu`; on a CPU tensor it runs its plain
version.  Both give the same bits: values are moved, never computed, and a
stored zero stays 1 in the pattern.  Each makes one launch and nothing else
a call (`densify_onehot` runs twice in every alg1 product,
`densify_onehot_pattern` on every tile of the blocked engines' symbolic
phase): its kernel writes each 4096-cell window of its outputs once, zeros
included, so no fill runs before it, and the wrapper checks its arguments
in one expression and launches through `_build.launch`.  The values may be
of any dtype of 2, 4, 8 or 16 bytes (bfloat16, float32, float64,
complex64, complex128, ...): the kernel moves each as one item of its
width, so every width is bitwise its plain version.
`densify_onehot_windows` repeats the window arithmetic on the CPU at any
window size, for tests.

The TPU kernels' static chunk plan (`densify_onehot_plan`) and their bf16
value splits exist because the TPU has no vector scatter; the CUDA kernels
need neither, so the port takes no plan.  Bound on the card: the bytes of
the dense outputs (w + 2 bytes a dense cell at values of w bytes, 2 for the
pattern alone).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import check_csr

# bytes of a value item the kernel moves (csrc/densify.cu's instances)
WIDTHS = (2, 4, 8, 16)


def densify_onehot_plain(indptr: torch.Tensor, indices: torch.Tensor,
                         data: torch.Tensor, m: int, k: int,
                         with_pattern: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel, on any device."""
    val = prim.csr_to_dense_canonical(indptr, indices, data, (m, k))
    if not with_pattern:
        return val, None
    ones = torch.ones_like(data, dtype=torch.bfloat16)
    pat = prim.csr_to_dense_canonical(indptr, indices, ones, (m, k))
    return val, pat


def densify_onehot_windows(indptr: torch.Tensor, indices: torch.Tensor,
                           data: torch.Tensor, m: int, k: int, window: int,
                           with_pattern: bool = True
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """CPU emulation of `csrc/densify.cu::densify_rows`, for tests: the flat
    (m, k) output cut into windows of `window` cells; each window zeroed,
    set from the entries of the rows [e0 // k, (e0 + n - 1) // k] that
    meet it (found from indptr), then written out whole."""
    cells = m * k
    val = torch.empty(cells, dtype=data.dtype)
    pat = torch.empty(cells, dtype=torch.bfloat16)
    ip = indptr.long()
    cols = indices.long()
    for e0 in range(0, cells, window):
        n = min(window, cells - e0)
        ra, rb = e0 // k, (e0 + n - 1) // k + 1
        p = torch.arange(int(ip[ra]), int(ip[rb]))
        rows = ra + prim.rows_from_indptr(ip[ra:rb + 1] - ip[ra],
                                          p.numel()).long()
        w = rows * k + cols[p] - e0
        keep = (cols[p] >= 0) & (cols[p] < k) & (w >= 0) & (w < n)
        win_val = torch.zeros(window, dtype=data.dtype)
        win_pat = torch.zeros(window, dtype=torch.bfloat16)
        win_val[w[keep]] = data[p[keep]]
        win_pat[w[keep]] = 1.0
        val[e0:e0 + n] = win_val[:n]
        pat[e0:e0 + n] = win_pat[:n]
    return val.view(m, k), pat.view(m, k) if with_pattern else None


def densify_onehot(indptr: torch.Tensor, indices: torch.Tensor,
                   data: torch.Tensor, m: int, k: int,
                   with_pattern: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dense (m, k) values of `data`'s dtype and, when `with_pattern`, the
    (m, k) bf16 structural 0/1 pattern (explicit zeros kept) of a canonical
    CSR."""
    # one expression on every call; the worded checks only where it fails
    dev = data.get_device()
    width = data.element_size()
    if not (indptr.dtype == indices.dtype == prim.INDEX_DTYPE
            and width in WIDTHS and indptr.shape == (m + 1,)
            and indices.dim() == 1 and indices.shape == data.shape
            and indptr.get_device() == indices.get_device() == dev
            and indptr.is_contiguous() and indices.is_contiguous()
            and data.is_contiguous()):
        check_csr(indptr, indices, data, m, "densify_onehot",
                  (data.dtype,) if width in WIDTHS else (torch.float32,))
        raise ValueError("densify_onehot: bad arguments")
    if not data.is_cuda:
        if data.device.type != "cpu":
            raise ValueError(f"densify_onehot: unsupported device "
                             f"{data.device}")
        return densify_onehot_plain(indptr, indices, data, m, k, with_pattern)
    if m == 0 or k == 0 or data.numel() == 0:
        # no launch: a zero-size grid is a launch error
        return (torch.zeros((m, k), dtype=data.dtype, device=data.device),
                torch.zeros((m, k), dtype=torch.bfloat16, device=data.device)
                if with_pattern else None)
    val = torch.empty((m, k), dtype=data.dtype, device=data.device)
    pat = (torch.empty((m, k), dtype=torch.bfloat16, device=data.device)
           if with_pattern else None)
    err = _build.launch(dev, "spmm_densify", indptr.data_ptr(),
                        indices.data_ptr(), data.data_ptr(), val.data_ptr(),
                        pat.data_ptr() if with_pattern else None, m, k,
                        width)
    _build.check(err, "densify_onehot")
    _build.LAUNCHES["densify_onehot"] += 1
    return val, pat


def densify_onehot_pattern_plain(indptr: torch.Tensor, indices: torch.Tensor,
                                 m: int, k: int) -> torch.Tensor:
    """Plain PyTorch version of the pattern kernel, on any device."""
    ones = torch.ones(indices.numel(), dtype=torch.bfloat16,
                      device=indices.device)
    return prim.csr_to_dense_canonical(indptr, indices, ones, (m, k))


def densify_onehot_pattern(indptr: torch.Tensor, indices: torch.Tensor,
                           m: int, k: int) -> torch.Tensor:
    """The (m, k) bf16 structural 0/1 pattern of a canonical CSR (explicit
    zeros kept, empty rows 0), with no value stream: the symbolic phase of
    the blocked alg2/alg3 engines."""
    # one expression on every call; the worded checks only where it fails
    dev = indices.get_device()
    if not (indptr.dtype == indices.dtype == prim.INDEX_DTYPE
            and indptr.shape == (m + 1,) and indices.dim() == 1
            and indptr.get_device() == dev and indptr.is_contiguous()
            and indices.is_contiguous()):
        check_csr(indptr, indices, None, m, "densify_onehot_pattern")
        raise ValueError("densify_onehot_pattern: bad arguments")
    if not indices.is_cuda:
        if indices.device.type != "cpu":
            raise ValueError(f"densify_onehot_pattern: unsupported device "
                             f"{indices.device}")
        return densify_onehot_pattern_plain(indptr, indices, m, k)
    if m == 0 or k == 0 or indices.numel() == 0:
        # no launch: a zero-size grid is a launch error
        return torch.zeros((m, k), dtype=torch.bfloat16, device=indices.device)
    pat = torch.empty((m, k), dtype=torch.bfloat16, device=indices.device)
    err = _build.launch(dev, "spmm_densify_pattern", indptr.data_ptr(),
                        indices.data_ptr(), pat.data_ptr(), m, k)
    _build.check(err, "densify_onehot_pattern")
    _build.LAUNCHES["densify_onehot_pattern"] += 1
    return pat
