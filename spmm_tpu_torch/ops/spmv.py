"""SpMV: y = alpha * op(A) @ x (CSR @ dense vector).

Port of `spmm_tpu/ops/spmv.py`, with its call shapes, tags and errors.  The
kernels (all in `ops/kernels/`, each with a plain PyTorch version that a
CPU tensor runs):

  * `spmv(a, x)` and `via="csr"`: `spmv_binned` over a per-call plan of
    row-length bins (`csrc/spmv_binned.cu`);
  * `plan=spmv_plan(a)`: the tagged plans `("routed", p)` (the serving
    plan, `csrc/spmv_routed.cu`), `("binned", p)` and `("onehot", p)`
    (`csrc/spmv_onehot.cu`);
  * `transa=True`: the CSR of Aᵀ by a stable sort (`CSR.transpose`), then
    `spmv_binned` on it, so the transposed product has no atomics either;
  * `via="dense"`: densify (kernel `densify_onehot`) and one `torch.matmul`
    with TF32 off.

`alpha`, rounded to A's dtype as JAX rounds it, multiplies the result after
the sum, as in the JAX package.  Dtypes are JAX's: the product is computed
in the common type of A and x (`torch.promote_types`, as JAX's promotion);
where that is float32 (float32, an int32 or bfloat16 A with a float32 x)
the float32 kernels above run, and for every other type (float64,
complex64, complex128, bfloat16, an int32 A with an int32 x) JAX's
gather-and-segment-sum path, `data * x[indices]` added row by row in
stored order from 0 by `segment_sum_inorder` (`csrc/segment_sum.cu` on the
card, JAX's bits on the CPU), as JAX gives every non-float32 matrix a plan
of None.  One departure: on the card, `spmv_plan` of a float64 matrix
gives the routed plan in float64 ("auto" and "max"), so that a solver's
repeated float64 SpMV (HPCG's CG) runs the serving kernel in float64
(`spmm_spmv_routed_f64`, fma in float64); off the card it is None, as in
the JAX package.  Every card path is deterministic, bitwise on rerun.

A call is the root span `spmv`, its path the child span `spmv.routed`,
`spmv.binned`, `spmv.onehot`, `spmv.gather` or `spmv.dense`; `spmv_plan`
is the root span `spmv_plan.build` (`utils/profiler.span`).
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.densify_onehot import densify_onehot
from spmm_tpu_torch.ops.kernels.spmv_binned import (spmv_binned,
                                                    spmv_binned_plan)
from spmm_tpu_torch.ops.kernels.spmv_onehot import (spmv_onehot,
                                                    spmv_onehot_plan)
from spmm_tpu_torch.ops.kernels.spmv_routed import (DTYPES, spmv_routed,
                                                    spmv_routed_plan)
from spmm_tpu_torch.ops.spgemm import _value_matmul
from spmm_tpu_torch.utils.profiler import span

_TAGS = ("routed", "binned", "onehot")


_WIDE = (torch.float64, torch.complex128)


def _check_sparse(a, what: str):
    """A, a sparse matrix of any format."""
    from spmm_tpu_torch.sparse.base import issparse

    if not issparse(a):
        raise TypeError(f"{what} expects a sparse matrix A")
    return a


def as_dense(x, a, what: str) -> torch.Tensor:
    """x as a tensor on A's device.  A host array converts as `jnp.asarray`
    does: with x64 on where A holds a 64-bit type (float64, complex128),
    as JAX with x64 enabled holds one, else with x64 off (float64 to
    float32, int64 to int32, complex128 to complex64); a tensor keeps its
    dtype, must lie on A's device, and is copied contiguous where it is
    not."""
    from spmm_tpu_torch.sparse.base import as_data

    if isinstance(x, torch.Tensor):
        if x.device != a.device:
            raise ValueError(f"{what}: the dense operand is on {x.device}, "
                             f"A on {a.device}")
        return x.contiguous()
    if a.dtype in _WIDE:
        return torch.as_tensor(np.asarray(x), device=a.device)
    return as_data(x, None, a.device)


def promote(a, x: torch.Tensor):
    """(A, x) in their common dtype, as JAX promotes `data * x`."""
    dtype = torch.promote_types(a.dtype, x.dtype)
    return (a if a.dtype == dtype else a.astype(dtype)), x.to(dtype)


def _scale(y: torch.Tensor, alpha, dtype) -> torch.Tensor:
    """alpha * y, alpha rounded to A's `dtype` first (JAX's
    `jnp.asarray(alpha, a.dtype)`)."""
    alpha = prim.scalar_as(alpha, dtype)
    return y if alpha == 1 else y.mul_(alpha)


def csr_gather_sum(a, x: torch.Tensor) -> torch.Tensor:
    """A @ x for x (n,) or (n, k) by JAX's non-kernel path: every entry's
    `data * x[col]`, summed row by row in stored order from 0
    (`segment_sum_inorder`: JAX's `segment_sum` bits, no atomics)."""
    ip = a.indptr
    if x.dim() == 1:
        prod = a.data * x[a.indices.long()]
    else:
        prod = x[a.indices.long()] * a.data[:, None]
    return prim.segment_sum_inorder(prod, ip[:-1], ip[1:] - ip[:-1])


def _csr_spmv(a, x: torch.Tensor) -> torch.Tensor:
    """A @ x through `spmv_binned` on a plan made for this call."""
    m, n = a.shape
    return spmv_binned(x, spmv_binned_plan(a.indptr, a.indices, a.data, m, n))


def _dense_spmv(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _value_matmul(a_dense, x)


def _densify(a) -> torch.Tensor:
    m, n = a.shape
    return densify_onehot(a.indptr, a.indices, a.data, m, n,
                          with_pattern=False)[0]


def _on_card(a) -> bool:
    return a.device.type == "cuda"


def spmv_onehot_plans(a):
    """The chunk plan of `spmv_onehot` for `a`, or None where the kernel
    does not apply: off the card, for non-f32 data, or an empty matrix."""
    a = a.tocsr()
    if not _on_card(a) or a.dtype != torch.float32 or a.nnz == 0:
        return None
    m, n = a.shape
    return spmv_onehot_plan(a.indptr, m, n)


def spmv_plan(a, effort: str = "auto"):
    """Preprocess `a` for repeated SpMV, the analogue of cuSPARSE's
    descriptor and analysis reuse.  Returns a tagged plan for
    `spmv(..., plan=...)` and `spmm(..., plan=...)`, or None.

    `effort`: "auto" and "max" give `("routed", p)`, the serving plan
    (SELL-32-sigma slices and chunked long rows, built once on the card),
    for float32 and float64 data; "fast" gives `("binned", p)`, the plan
    `spmv` also makes per call, for float32 data.  As in the JAX package,
    the plan is None off the accelerator (here: a matrix not on a CUDA
    device), for other data and for an empty matrix; unlike it, a float64
    matrix on the card gets the routed plan in float64 (module docstring).
    """
    if effort not in ("auto", "max", "fast"):
        raise ValueError(f"unknown effort {effort!r} (expected 'auto', "
                         "'max' or 'fast')")
    with span("spmv_plan.build"):
        return _plan(a, effort)


def _plan(a, effort: str):
    """`spmv_plan` without its span (`spmv` makes the "fast" one per
    call)."""
    a = a.tocsr()
    routed = effort in ("auto", "max")
    dtypes = DTYPES if routed else (torch.float32,)
    if not _on_card(a) or a.dtype not in dtypes or a.nnz == 0:
        return None
    a = a.sum_duplicates()
    m, n = a.shape
    if routed:
        return ("routed", spmv_routed_plan(a.indptr, a.indices, a.data, m, n))
    return ("binned", spmv_binned_plan(a.indptr, a.indices, a.data, m, n))


def spmv(a, x, alpha=1.0, transa: bool = False, via: str = "auto",
         plan=None):
    """y = alpha * op(A) @ x.

    Validation follows cusparse.spmv: A sparse (TypeError), x a 1-D dense
    vector of the matching length (ValueError).  `via`: "auto" (the binned
    kernel, or the kernel of `plan`), "binned", "onehot", "csr" or "dense".
    `via="binned"`/`"onehot"` without a plan raise ValueError off the card,
    as the JAX package does off the TPU.  A call is the root span `spmv`
    (module docstring).
    """
    with span("spmv"):
        a = _check_sparse(a, "spmv").tocsr()
        x = as_dense(x, a, "spmv")
        if x.dim() != 1:
            raise ValueError("spmv expects a 1-D dense vector x")
        m, n = a.shape
        expected = m if transa else n
        if x.shape[0] != expected:
            raise ValueError(
                f"dimension mismatch: op(A) {a.shape} (transa={transa}) @ x "
                f"{tuple(x.shape)}")
        a_dtype = a.dtype
        a, x = promote(a, x)
        if via == "dense":
            with span("spmv.dense"):
                ad = _densify(a.sum_duplicates())
                return _scale(_dense_spmv(ad.T if transa else ad, x), alpha,
                              a_dtype)
        if not transa and via in ("auto", "onehot", "binned"):
            a = a.sum_duplicates()  # the kernels need canonical entries
            if (plan is not None and isinstance(plan, tuple)
                    and len(plan) == 2 and plan[0] in _TAGS):
                tag, p = plan
            elif plan is not None:
                tag, p = "onehot", plan  # a bare onehot plan
            elif via in ("auto", "binned"):
                tag, p = _plan(a, "fast") or (None, None)
            else:
                tag, p = "onehot", spmv_onehot_plans(a)
            if tag == "routed" and p is not None:
                with span("spmv.routed"):
                    return _scale(spmv_routed(x, p), alpha, a_dtype)
            if tag == "binned" and p is not None:
                with span("spmv.binned"):
                    return _scale(spmv_binned(x, p), alpha, a_dtype)
            if tag == "onehot" and p is not None:
                with span("spmv.onehot"):
                    return _scale(spmv_onehot(a.indptr, a.indices, a.data,
                                              x, m, n, p), alpha, a_dtype)
            if via in ("onehot", "binned"):
                raise ValueError(f"spmv via={via!r} requested but the "
                                 "kernel does not apply (matrix not on a CUDA "
                                 "device, non-f32 data, or an empty matrix)")
        a = a.sum_duplicates()
        if transa:
            a = a.transpose()
        if a.dtype != torch.float32:
            with span("spmv.gather"):
                return _scale(csr_gather_sum(a, x), alpha, a_dtype)
        with span("spmv.binned"):
            return _scale(_csr_spmv(a, x), alpha, a_dtype)
