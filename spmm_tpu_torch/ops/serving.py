"""Fixed-structure SpGEMM serving plans (preprocess once, execute many).

Port of `spmm_tpu/ops/serving.py`.  The structure of C = A @ B is fixed by
the structures of A and B, so `spgemm_plan(a, b)` resolves it once on the
host (the structural product) and keeps, on the operands' device:

  * the densify plans of A and B (`kernels/route.expand_route_plan`);
  * the output structure (indptr, indices) and its extraction plan
    (`kernels/route.compress_plan_from_flat`).

Per call only the values change: `expand_routed` for A and for B, one
float32 value GEMM in the plan's `precision` (`spgemm._value_matmul`:
"highest" IEEE, "high" 3xTF32, "default" one TF32 pass),
`compress_routed` with alpha.  No host sync:
the output CSR is built with the constructor, which checks nothing on the
device.  The dense operands are bitwise those of `spgemm(alg=1)`, and so is
the structure; the values are the same GEMM's, so they match alg 1 bitwise
where the GEMM library picks the same algorithm for both calls.

A plan computes in float32 whatever its operands' dtype, as JAX's does:
the values of a plan of another dtype (float64, complex, bfloat16) are cast
to float32 before the densify (a complex value keeps its real part) and a
call's CSR is cast back to that dtype; `values` and `values_batch` return
float32, as JAX's.  The values given to a float32 plan must be float32.

The JAX `interpret` argument is a Pallas switch and is dropped.  The JAX
plans fall back to an XLA scatter and gather where a routing table does
not apply; the port's plans apply to every structure, so `use_routed` is
accepted for signature parity and has no effect.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.route import (
    compress_plan_from_flat, densify_routed, expand_route_plan,
    extract_routed)
from spmm_tpu_torch.ops.spgemm import _check_precision, _value_matmul
from spmm_tpu_torch.utils.profiler import span


def _structural_product(a, b) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host structural product: (indptr, indices, flat_positions) of the
    pattern of A @ B (counts > 0, explicit zeros structural: the alg1 mask
    semantics, `spgemm._alg1_dense_compute`), in the span
    `spgemm.structure`."""
    with span("spgemm.structure"):
        m, k = a.shape
        n = b.shape[1]
        ai, aj, bi, bj = prim.to_host(a.indptr, a.indices, b.indptr,
                                      b.indices, what="operands")
        try:
            import scipy.sparse as sp

            Pa = sp.csr_matrix(
                (np.ones(aj.shape[0], np.float64), aj, ai), shape=(m, k))
            Pb = sp.csr_matrix(
                (np.ones(bj.shape[0], np.float64), bj, bi), shape=(k, n))
            C = (Pa @ Pb).tocsr()
            C.sort_indices()
            rows = np.repeat(np.arange(m, dtype=np.int64),
                             np.diff(C.indptr))
            flat = rows * n + C.indices.astype(np.int64)
            return (C.indptr.astype(np.int32), C.indices.astype(np.int32),
                    flat)
        except ImportError:
            da = np.zeros((m, k), np.float32)
            db = np.zeros((k, n), np.float32)
            rows_a = np.repeat(np.arange(m), np.diff(ai))
            rows_b = np.repeat(np.arange(k), np.diff(bi))
            da[rows_a, aj] = 1.0
            db[rows_b, bj] = 1.0
            mask = (da @ db) > 0
            flat = np.flatnonzero(mask.ravel()).astype(np.int64)
            lens = np.bincount(flat // n, minlength=m)
            indptr = np.zeros((m + 1,), np.int32)
            np.cumsum(lens, out=indptr[1:])
            return indptr, (flat % n).astype(np.int32), flat


class SpgemmPlan:
    """Preprocessed fixed-structure SpGEMM: C = alpha * A @ B where the
    sparsity structures of A and B are frozen at plan time and only the
    values change per call.  Build with `spgemm_plan(a, b)`; call with new
    value arrays.  The output structure (indptr/indices/nnz) is a plan
    constant; every call returns a CSR sharing those tensors."""

    def __init__(self, a, b, precision: str = "highest",
                 use_routed: Optional[bool] = None):
        del use_routed  # every plan applies on this card (module docstring)
        with span("spgemm_plan.build"):
            _check_precision(precision)
            a = a.sum_duplicates()
            b = b.sum_duplicates()
            m, k = a.shape
            n = b.shape[1]
            dev = a.device
            self.shape = (m, n)
            self.dtype = a.data.dtype
            self.precision = precision
            # JAX computes every plan in float32 (module docstring)
            self._cast = (a.dtype != torch.float32
                          or b.dtype != torch.float32)
            self.nnz_a = int(a.nnz)
            self.nnz_b = int(b.nnz)

            indptr_h, indices_h, flat = _structural_product(a, b)
            self.nnz = int(flat.size)
            self._pa = expand_route_plan(a.indptr, a.indices, m, k, dev)
            self._pb = expand_route_plan(b.indptr, b.indices, k, n, dev)
            self._pc = compress_plan_from_flat(flat, m, n, dev)
            if self._pc is not None:
                self.indptr, self.indices = self._pc.indptr, self._pc.indices
            else:
                self.indptr = torch.from_numpy(indptr_h).to(dev)
                self.indices = torch.from_numpy(indices_h).to(dev)
            self.routed = (True, True, self._pc is not None)

    def _product(self, a_data, b_data, ad=None, bd=None, c=None):
        """Dense alpha-free float32 product A @ B of the given values;
        `ad`, `bd` and `c` are optional workspaces to write into."""
        if self._cast:
            a_data, b_data = a_data.to(torch.float32), b_data.to(
                torch.float32)
        ad = densify_routed(a_data, self._pa, emit_pattern=False, out=ad)
        bd = densify_routed(b_data, self._pb, emit_pattern=False, out=bd)
        return _value_matmul(ad, bd, self.precision, out=c)

    def __call__(self, a_data, b_data, alpha=1.0):
        from spmm_tpu_torch.sparse.csr import CSR

        with span("spgemm_plan.call"):
            vals = self._values(a_data, b_data, alpha)
            if self._cast:
                vals = vals.to(self.dtype)
            return CSR._wrap(self.indptr, self.indices, vals, self.shape,
                             canonical=True)

    def values(self, a_data, b_data, alpha=1.0) -> torch.Tensor:
        """Just the output value array (CSR order): the minimal per-call
        product for pipelines that keep the static structure elsewhere."""
        with span("spgemm_plan.call"):
            return self._values(a_data, b_data, alpha)

    def _values(self, a_data, b_data, alpha):
        self._check_sizes(a_data, b_data)
        if self._pc is None:
            return torch.zeros(0, dtype=torch.float32, device=a_data.device)
        return extract_routed(self._product(a_data, b_data), self._pc, alpha)

    def values_accumulate(self, c_vals, a_data, b_data, alpha=1.0,
                          beta=1.0) -> torch.Tensor:
        """C_vals <- beta * C_vals + alpha * (A @ B) over the planned
        structure, written into `c_vals` in place and returned: one
        persistent C buffer across repeated numeric phases (the JAX
        package donates the buffer to the same end).

        The result has JAX's dtype, that of float32 beta times `c_vals`
        plus the float32 product: `c_vals`' own for float32, float64 and
        complex (in place), float32 for bfloat16 and float16, returned as
        a new tensor (JAX cannot alias that output onto the buffer
        either)."""
        with span("spgemm_plan.call"):
            self._check_sizes(a_data, b_data)
            if c_vals.shape[0] != self.nnz:
                raise ValueError(f"c_vals size {c_vals.shape[0]} != planned "
                                 f"nnz {self.nnz}")
            narrow = torch.promote_types(torch.float32,
                                         c_vals.dtype) != c_vals.dtype
            if self._pc is None:
                return c_vals.to(torch.float32) if narrow else c_vals
            if narrow:
                return extract_routed(self._product(a_data, b_data), self._pc,
                                      alpha, c_prev=c_vals.to(torch.float32),
                                      beta=beta)
            if c_vals.dtype != torch.float32:
                vals = extract_routed(self._product(a_data, b_data), self._pc,
                                      alpha)
                return c_vals.mul_(prim.f32(beta)).add_(vals)
            return extract_routed(self._product(a_data, b_data), self._pc,
                                  alpha, c_prev=c_vals, beta=beta, out=c_vals)

    def values_batch(self, a_vals, b_vals, alpha=1.0) -> torch.Tensor:
        """(K, nnz_a) x (K, nnz_b) -> (K, nnz): K multiplies in a loop over
        one set of dense workspaces (A, B and C each allocated once, as the
        JAX scan keeps one set live).  `alpha` may be a scalar or a (K,)
        vector; a vector on the card is read to the host once."""
        with span("spgemm_plan.call"):
            if a_vals.ndim != 2 or b_vals.ndim != 2:
                raise ValueError(
                    "values_batch expects stacked (K, nnz) arrays")
            if a_vals.shape[0] != b_vals.shape[0]:
                raise ValueError(
                    f"batch sizes differ: {a_vals.shape[0]} vs "
                    f"{b_vals.shape[0]}")
            if (a_vals.shape[1] != self.nnz_a
                    or b_vals.shape[1] != self.nnz_b):
                raise ValueError(
                    f"value array sizes {a_vals.shape[1]}/{b_vals.shape[1]} "
                    f"do not match the planned structures "
                    f"{self.nnz_a}/{self.nnz_b}")
            K = a_vals.shape[0]
            dev = a_vals.device
            if isinstance(alpha, torch.Tensor):
                alpha = prim.read_host(alpha, "alpha")
            alphas = np.broadcast_to(np.asarray(alpha, np.float32), (K,))
            out = torch.empty((K, self.nnz), dtype=torch.float32, device=dev)
            if self._pc is None or K == 0:
                return out
            m, n = self.shape
            ad = torch.empty((m, self._pa.k), dtype=torch.float32, device=dev)
            bd = torch.empty((self._pb.m, n), dtype=torch.float32, device=dev)
            c = torch.empty((m, n), dtype=torch.float32, device=dev)
            for i in range(K):
                self._product(a_vals[i], b_vals[i], ad, bd, c)
                extract_routed(c, self._pc, alphas[i], out=out[i])
            return out

    def _check_sizes(self, a_data, b_data):
        if a_data.shape[0] != self.nnz_a or b_data.shape[0] != self.nnz_b:
            raise ValueError(
                f"value array sizes {a_data.shape[0]}/{b_data.shape[0]} do "
                f"not match the planned structures "
                f"{self.nnz_a}/{self.nnz_b}")


def spgemm_plan(a, b, precision: str = "highest",
                use_routed: Optional[bool] = None) -> SpgemmPlan:
    """Preprocess the fixed-structure SpGEMM `C = alpha * A @ B`.

    Returns a `SpgemmPlan`; call it with per-step value tensors (or the
    same matrices' `.data`), on the operands' device.  Mirrors the
    reference's staged reuse (cusparse.py workEstimation/compute stages
    cached across calls), with the whole structure resolved at plan time
    on the host."""
    from spmm_tpu_torch.sparse.csr import CSR

    if not isinstance(a, CSR) or not isinstance(b, CSR):
        raise TypeError("spgemm_plan expects CSR matrices")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and "
                         f"{b.device}")
    return SpgemmPlan(a, b, precision, use_routed)
