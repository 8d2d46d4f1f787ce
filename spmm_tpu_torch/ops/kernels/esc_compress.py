"""ESC's compress: lex-sorted (row, col, val) triplets -> canonical CSR,
each run of equal (row, col) summed by the fixed doubling tree.

The JAX package compresses with `jnp` ops (`spmm_tpu/ops/spgemm.py::
_compress`: `_primitives.segsum_tree`, a Hillis-Steele scan of log2(P)
passes, then the run heads' positions and gathers); no Pallas kernel.  On a
CUDA tensor the port runs two kernels of `csrc/esc_compress.cu` instead, one
C call each: `count_runs` (the number of runs, for the host's sizing
readback) and `compress_runs` (every run summed in the scan's association,
its column, alpha times its sum and the indptr written once).  A run's total
under the scan depends on the run alone, so the kernel sums each run in one
pass and gives the scan's bits at every run length (the source says how).

On a CPU tensor both take their plain versions, the code ESC ran before
the kernels: `count_unique_sorted`, and `sum_duplicates_sorted_tree`
(`segsum_tree`), alpha's product and `build_indptr`'s search.

Every dtype ESC takes goes through the kernel on the card: float32,
float64, bfloat16, complex64 and complex128, each added and scaled as
torch's card ops do, so the bits are the plain version's there; another
dtype raises on a CUDA device.  `count_runs` reads rows and columns only.
Bound on the card: bytes (rows and columns read in each kernel, values
once, the outputs written once).
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build

# the kernel's value types (csrc/esc_compress.cu's dtype codes)
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
           torch.complex64: 3, torch.complex128: 4}
TILE = 2048  # positions a tile of `compress_runs`: one status word each


def count_runs_plain(row_s: torch.Tensor, col_s: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of `count_runs`."""
    return prim.count_unique_sorted(row_s, col_s)


def count_runs(row_s: torch.Tensor, col_s: torch.Tensor) -> torch.Tensor:
    """The number of runs of equal pairs in lex-sorted int32 (row, col), as
    a 0-d int64 tensor on their device.  No host sync."""
    _check_pairs(row_s, col_s)
    P = row_s.numel()
    if not row_s.is_cuda or P == 0:
        return count_runs_plain(row_s, col_s)
    out = torch.empty((), dtype=torch.int64, device=row_s.device)
    err = _build.launch(row_s.get_device(), "spmm_esc_count",
                        row_s.data_ptr(), col_s.data_ptr(), P,
                        out.data_ptr())
    _build.check(err, "esc_count")
    _build.LAUNCHES["esc_count"] += 1
    return out


def compress_runs_plain(row_s, col_s, val_s, alpha, indptr, col, val,
                        row_lo: int = 0, base: int = 0) -> None:
    """Plain PyTorch version of `compress_runs`."""
    r, c, v = prim.sum_duplicates_sorted_tree(row_s, col_s, val_s,
                                              col.numel())
    col.copy_(c)
    val.copy_(v * prim.scalar_as(alpha, v.dtype))
    bounds = torch.arange(row_lo, row_lo + indptr.numel(), dtype=r.dtype,
                          device=r.device)
    indptr.copy_(torch.searchsorted(r, bounds, out_int32=True) + base)


def compress_runs(row_s: torch.Tensor, col_s: torch.Tensor,
                  val_s: torch.Tensor, alpha, indptr: torch.Tensor,
                  col: torch.Tensor, val: torch.Tensor, row_lo: int = 0,
                  base: int = 0) -> None:
    """Sum each run of equal pairs of the lex-sorted triplets (row_s,
    col_s, val_s) with the fixed doubling tree, in order of the runs: run j
    writes its column to col[j] and alpha times its sum to val[j] (alpha
    rounded to the values' dtype once), so `col` and `val` hold one slot a
    run.  indptr[i] becomes `base` plus the number of runs whose row is
    below row_lo + i, for i = 0 .. len(indptr) - 1; the triplets' rows lie
    in [row_lo, row_lo + len(indptr) - 1).  With row_lo = 0, base = 0 and
    m + 1 entries it is the CSR's indptr; a chunk of rows writes its own
    slice of one (`_alg3_esc_compute`)."""
    _check_pairs(row_s, col_s)
    P = row_s.numel()
    nnz = col.numel()
    dev = row_s.device
    if (val_s.shape != row_s.shape or val.shape != (nnz,)
            or val.dtype != val_s.dtype or col.dtype != prim.INDEX_DTYPE
            or indptr.dtype != prim.INDEX_DTYPE or indptr.dim() != 1
            or indptr.numel() < 1 or not (indptr.is_contiguous()
                                          and col.is_contiguous()
                                          and val.is_contiguous()
                                          and val_s.is_contiguous())
            or any(x.device != dev for x in (val_s, indptr, col, val))):
        raise ValueError("compress_runs: val_s must match row_s; indptr "
                         "and col contiguous int32, val contiguous of "
                         "val_s's dtype and col's length, all on "
                         f"{dev}")
    if not row_s.is_cuda:
        compress_runs_plain(row_s, col_s, val_s, alpha, indptr, col, val,
                            row_lo, base)
        return
    code = _DTYPES.get(val_s.dtype)
    if code is None:
        raise NotImplementedError(f"compress_runs of {val_s.dtype} on a "
                                  "CUDA device")
    if P == 0:
        indptr.fill_(base)
        return
    # the ticket and one status word a tile, zeroed by the C entry
    ws = torch.empty(-(-P // TILE) + 1, dtype=torch.int64, device=dev)
    a = complex(prim.scalar_as(alpha, val_s.dtype))
    err = _build.launch(row_s.get_device(), "spmm_esc_compress",
                        row_s.data_ptr(), col_s.data_ptr(), val_s.data_ptr(),
                        P, a.real, a.imag,
                        indptr.data_ptr(), row_lo, indptr.numel() - 1, base,
                        col.data_ptr(), val.data_ptr(), nnz, ws.data_ptr(),
                        code)
    _build.check(err, "esc_compress")
    _build.LAUNCHES["esc_compress"] += 1


def _check_pairs(row_s: torch.Tensor, col_s: torch.Tensor) -> None:
    if (row_s.dtype != prim.INDEX_DTYPE or col_s.dtype != prim.INDEX_DTYPE
            or row_s.dim() != 1 or row_s.shape != col_s.shape
            or row_s.device != col_s.device or not row_s.is_contiguous()
            or not col_s.is_contiguous()):
        raise ValueError("esc_compress: row_s and col_s must be contiguous "
                         "1-D int32 tensors of one length and device")
    if row_s.numel() >= 2**31:
        raise ValueError(f"esc_compress: {row_s.numel()} triplets, past "
                         "the 2^31 an int32 position holds")
