"""SpMM: C = alpha * op(A) @ B (sparse @ dense matrix).

Port of `spmm_tpu/ops/spmm.py`.  Paths:

  * `via="csr"` (the default): `spmm_routed`'s kernel
    (`csrc/spmm_routed.cu`, a group of lanes per row and up to 128 columns
    of B) over a plan made for this call that holds only the chunks of the
    long rows;
  * `plan=("routed", p)` from `spmv_plan(a)`: the same kernel over the
    serving plan's row order (ignored with `transa`, as in JAX, and for a
    float64 plan, which the float32 kernel does not take: a float64 A
    takes the float64 path below);
  * `via="dense"`: densify (kernel `densify_onehot`) and one `torch.matmul`
    with TF32 off;
  * `via="bsr_pallas"`: the hand-written BSR kernel `bsr_spmm`
    (`csrc/bsr_spmm.cu`); a non-BSR A is re-tiled with `tobsr()` first;
  * `via="bsr"`, or a BSR A with any other `via`: JAX's `_bsr_spmm` route,
    which is XLA's `dot_general` and `segment_sum` there, no Pallas: here
    `bsr_spmm_plain`, one `torch.bmm` in IEEE f32 and the in-order
    block-row sum, on every device.

`transa` transposes A first (a CSR by a stable sort, `CSR.transpose`, so
the transposed product has no atomics either; a BSR through CSR, to blocks
of (C, R)).  B is row-major; a non-contiguous tensor (such as `X.T`) is
copied contiguous first.  `alpha`, rounded to A's dtype, multiplies the
result after the sum.

Dtypes are JAX's: A and B are promoted to their common type (a host B
converts as `spmv`'s x does).  Where that is float32 the paths above run.
For every other type, `via="csr"` takes JAX's `_csr_spmm`, `B[col] *
data` added row by row in stored order (`spmv.csr_gather_sum`), `"dense"`
one `torch.matmul` in that type and `"bsr"` `bsr_spmm_plain` in that type
(JAX's `_bsr_spmm`).  `"bsr_pallas"` launches `bsr_spmm` in the blocks'
dtype, as the TPU kernel computes in it: bfloat16, float64 and int32 on
the kernel's FMA path; a complex dtype raises, as JAX's kernel does.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm_plain, spmm_bsr
from spmm_tpu_torch.ops.kernels.spmv_routed import (spmm_routed,
                                                    spmv_routed_plan)
from spmm_tpu_torch.ops.spgemm import _value_matmul
from spmm_tpu_torch.ops.spmv import (_check_sparse, _densify, _scale,
                                     as_dense, csr_gather_sum, promote)


def _csr_spmm(a, b: torch.Tensor) -> torch.Tensor:
    """A @ B through `spmm_routed` on a per-call plan of long-row chunks."""
    m, n = a.shape
    plan = spmv_routed_plan(a.indptr, a.indices, a.data, m, n, sell=False)
    return spmm_routed(b, plan)


def _dense_spmm(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _value_matmul(a_dense, b)


def spmm(a, b, alpha=1.0, transa: bool = False, via: str = "csr",
         plan=None):
    """C = alpha * op(A) @ B with A sparse (any format) and B dense 2-D.

    `plan` may carry a routed plan from `spmv_plan(a)`, the SpMM analogue of
    cuSPARSE's descriptor reuse."""
    from spmm_tpu_torch.sparse.bsr import BSR

    a = _check_sparse(a, "spmm")
    b = as_dense(b, a, "spmm")
    if b.dim() != 2:
        raise ValueError("spmm expects a 2-D dense matrix B")
    if transa:
        a = a.transpose()
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {tuple(b.shape)}")
    a_dtype = a.dtype
    a, b = promote(a, b)
    if (plan is not None and isinstance(plan, tuple) and len(plan) == 2
            and plan[0] == "routed" and not transa
            and plan[1].data.dtype == torch.float32):
        return _scale(spmm_routed(b, plan[1]), alpha, a_dtype)
    if via == "dense":
        return _scale(_dense_spmm(_densify(a.tocsr().sum_duplicates()), b),
                      alpha, a_dtype)
    if via in ("bsr", "bsr_pallas") or isinstance(a, BSR):
        ab = a if isinstance(a, BSR) else a.tobsr()
        if via == "bsr_pallas":
            return _scale(spmm_bsr(ab, b), alpha, a_dtype)
        return _scale(bsr_spmm_plain(ab.indptr, ab.indices, ab.data, b,
                                     a.shape[0]), alpha, a_dtype)
    a = a.tocsr().sum_duplicates()
    if a.dtype != torch.float32:
        return _scale(csr_gather_sum(a, b), alpha, a_dtype)
    return _scale(_csr_spmm(a, b), alpha, a_dtype)
