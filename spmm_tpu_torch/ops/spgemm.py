"""SpGEMM C = alpha * A @ B, both CSR: the alg1 dense-intermediate path.

Port of the alg1 part of `spmm_tpu/ops/spgemm.py`, in the same order of
operations, so the output comes out in the same form:

  1. densify A and B into f32 values plus bf16 structural 0/1 patterns
     (kernel `densify_onehot`, `csrc/densify.cu`);
  2. one f32 value GEMM (TF32 off: `precision="highest"`) and one bf16
     pattern-count GEMM whose `> 0` is the structural mask, so entries that
     cancel numerically stay in the output, as in cuSPARSE and scipy's
     structure;
  3. read nnz on the host (the `spMatGetSize` analogue), then compact the
     dense product into CSR in row-major order (kernel `extract_roll`,
     `csrc/extract.cu`).

The GEMMs are `torch.matmul`, as the JAX package leaves them to XLA.  alg 2
and 3 (expand-sort-compress and the blocked engines) are not ported yet.
The JAX marker trick (`_TINY`, `_densify_marked`, `_tiny_collision`,
`densify_split_plan`) and the Pallas plans (`alg1_onehot_plans`) are TPU
workarounds: the CUDA densify writes the pattern from the structure itself.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.densify_onehot import densify_onehot
from spmm_tpu_torch.ops.kernels.extract_roll import extract_roll

INDEX_DTYPE = prim.INDEX_DTYPE

# dense-intermediate auto-dispatch budget (bytes of dense temporaries)
_DENSE_BUDGET_BYTES = int(2e9)


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """f32 matmuls in full IEEE f32 (no TF32) inside the block; the global
    setting is restored after."""
    mm = torch.backends.cuda.matmul
    old = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = old


def _alg1_dense_compute(a, b, alpha, precision: str = "highest"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense value and structural-pattern products; returns (alpha*C, mask,
    nnz) with nnz a 0-d int64 tensor on the operands' device."""
    _check_precision(precision)
    m, k = a.shape
    n = b.shape[1]
    ad, a_pat = densify_onehot(a.indptr, a.indices, a.data, m, k)
    bd, b_pat = densify_onehot(b.indptr, b.indices, b.data, k, n)
    with _ieee_fp32_matmul():
        c = torch.matmul(ad, bd)
    # bf16 0/1 terms: every partial sum is a positive count or 0, so
    # `> 0` is exact even where the bf16 GEMM rounds its sums or reduces
    # in reduced precision (allow_bf16_reduced_precision_reduction)
    counts = torch.matmul(a_pat, b_pat)
    mask = counts > 0
    nnz = mask.sum()
    if alpha != 1:
        c.mul_(alpha)
    return c, mask, nnz


def _check_precision(precision: str) -> None:
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet; only 'highest' "
            "(IEEE f32) is (ROADMAP §1.2, precision modes)")


def _dense_extract(c, mask, nnz: int):
    """Compaction of the kept cells; one kernel for every hole count."""
    return extract_roll(c, mask, nnz)


def _spgemm_alg1(a, b, alpha, precision: str = "highest"):
    from spmm_tpu_torch.sparse.csr import CSR

    m = a.shape[0]
    n = b.shape[1]
    c, mask, nnz_dev = _alg1_dense_compute(a, b, alpha, precision)
    nnz = int(nnz_dev)  # host sync: the analogue of spMatGetSize
    indptr, col, data = _dense_extract(c, mask, nnz)
    return CSR(indptr, col, data, (m, n), canonical=True)


def _alg1_fixed(a, b, alpha, cap: int, precision: str = "highest"):
    """ALG1 with a static output capacity and no host sync: (indptr, col,
    data, nnz) with `col`/`data` of length `cap`, zero past nnz, and indptr
    clamped to `cap` so the padded container stays self-consistent even
    when cap < nnz."""
    c, mask, nnz = _alg1_dense_compute(a, b, alpha, precision)
    indptr, col, data = extract_roll(c, mask, cap)
    return torch.clamp(indptr, max=cap), col, data, nnz


def _check_operands(a, b) -> None:
    from spmm_tpu_torch.sparse.csr import CSR

    if not isinstance(a, CSR) or not isinstance(b, CSR):
        raise TypeError("spgemm expects CSR matrices (csr @ csr), matching "
                        "cusparse.spgemm validation")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and "
                         f"{b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise NotImplementedError(
            f"spgemm of {a.dtype} @ {b.dtype}: only float32 is ported yet "
            "(ROADMAP §1.2, dtypes)")


def spgemm(a, b, alpha=1.0, alg: int = 0, precision: str = "highest"):
    """C = alpha * A @ B, both CSR, as a canonical CSR on the operands'
    device.  `alg` follows the modified `cupyx.cusparse.spgemm`: 1 is the
    dense-intermediate path; 0 takes it when the dense temporaries fit
    `_DENSE_BUDGET_BYTES`."""
    _check_operands(a, b)
    if alg not in (0, 1, 2, 3):
        raise ValueError(f"unknown alg {alg!r} (expected 0, 1, 2 or 3)")
    _check_precision(precision)
    a = a.sum_duplicates()
    b = b.sum_duplicates()
    if alg in (0, 1):
        m, k = a.shape
        n = b.shape[1]
        dense_bytes = 4 * (m * k + k * n + 2 * m * n)
        if alg == 1 or dense_bytes <= _DENSE_BUDGET_BYTES:
            return _spgemm_alg1(a, b, alpha, precision)
    raise NotImplementedError(
        f"spgemm alg={alg} (or alg=0 past the {_DENSE_BUDGET_BYTES}-byte "
        "dense budget) needs the ESC and blocked engines, not ported yet "
        "(ROADMAP §1.5 ESC alg2/alg3, §1.6 blocked engines)")


def spgemm_fixed(a, b, alpha=1.0, cap: Optional[int] = None,
                 precision: str = "highest"):
    """(CSR padded to `cap`, true nnz as a 0-d tensor).  `cap` defaults to
    the exact output nnz, found by one sizing pass.  Raises if `cap` is
    smaller than the true nnz."""
    from spmm_tpu_torch.sparse.csr import CSR

    _check_operands(a, b)
    _check_precision(precision)
    a = a.sum_duplicates()
    b = b.sum_duplicates()
    m = a.shape[0]
    n = b.shape[1]
    if cap is None:
        _, _, nnz_dev = _alg1_dense_compute(a, b, alpha, precision)
        cap = int(nnz_dev)
    indptr, col, data, nnz = _alg1_fixed(a, b, alpha, cap, precision)
    nnz_true = int(nnz)
    if nnz_true > cap:
        raise ValueError(
            f"spgemm_fixed: capacity {cap} is smaller than the true output "
            f"nnz {nnz_true}; rerun with cap >= {nnz_true} (or cap=None for "
            "exact sizing)")
    return CSR(indptr, col, data, (m, n), canonical=True), nnz


def spgemm_nnz_estimate(a, b) -> Tuple[int, int]:
    """(intermediate products P, upper bound on nnz(C)), in host int64."""
    if not a.nnz or not b.nnz:
        return 0, 0
    lens = np.diff(b.indptr.cpu().numpy()).astype(np.int64)
    P = int(lens[a.indices.cpu().numpy()].sum())
    return P, min(P, a.shape[0] * b.shape[1])
