"""SpGEMM C = alpha * A @ B, both CSR: the alg1 dense-intermediate path,
the expand-sort-compress (ESC) alg2/alg3 engine, and the dispatch to the
blocked dense alg2/alg3 engines (`ops/spgemm_blocked.py`).

Port of `spmm_tpu/ops/spgemm.py`, in the same order of operations, so the
output comes out in the same form.  alg1:

  1. densify A and B into values plus bf16 structural 0/1 patterns
     (kernel `densify_onehot`, `csrc/densify.cu`, at every element width);
  2. one value GEMM (`_value_matmul`, in the `precision` asked for) and one
     bf16 pattern-count GEMM whose `> 0` is the structural mask, so entries
     that cancel numerically stay in the output, as in cuSPARSE and scipy's
     structure;
  3. read nnz on the host (the `spMatGetSize` analogue), then compact the
     dense product into CSR in row-major order (kernel `extract_roll`,
     `csrc/extract.cu`).

ESC (alg2, and alg3 over row chunks of about `chunk_fraction` of the
products each): expand every partial product a_ik * b_kj in A-entry then
B-row order, stable-lexsort by (row, col), sum each run with the fixed
doubling tree (`_primitives.segsum_tree`).  Every product is one multiply
in the operands' dtype and the tree is the JAX package's, so the values
are bitwise those
of `spmm_tpu` (and of `native/spgemm_cross_check.cpp`), on every device, for
every chunk fraction; a float64 product and tree give JAX's float64 bits
on the CPU too.  ESC has no Pallas kernel; it is plain PyTorch here as
it is plain JAX there.  `spgemm` sends alg2/alg3 to the blocked dense
engines where A and B dense panels fit the budget (`_blocked_feasible`) and
to ESC elsewhere, as the JAX package does.

Dtypes are JAX's: float32, float64, complex64, complex128 and bfloat16,
each computed in its own type (the GEMM is cuBLAS's SGEMM, DGEMM, CGEMM,
ZGEMM or a bf16 GEMM with a bf16 output, as JAX's
`preferred_element_type=a.dtype`); operands of two dtypes are promoted to
their common type first, and alpha is rounded to A's dtype, as in JAX.

Precision modes of the float32 value GEMM (JAX's `jax.lax.Precision`):
"highest" is IEEE float32 (TF32 off); "default" one TF32 pass; "high" the
3xTF32 split: each operand split into a big part (rounded to TF32, its low
13 mantissa bits clear) and a small part (the remainder, rounded the same
way), then big·small + small·big + big·big as three TF32 GEMMs, the two
small terms added first, as `csrc/bsr_spmm.cu` splits on the tensor cores.
TF32 is set only inside a context that restores the global setting.
On the CPU torch has no TF32, so every mode is IEEE float32, as JAX's CPU
backend computes every mode.  The other dtypes ignore the mode (complex64
runs with TF32 off).  The pattern-count GEMM is bf16 in every mode, and
exact.

How close "high" comes depends on the operands: the three GEMMs keep
cuBLAS's long accumulate, with no fresh accumulator every 8 of K as
`csrc/bsr_spmm.cu` starts.  It holds the 1e-6 gate (rtol 1e-6 + atol
1e-6 max|C|) on the SpGEMM cells' operands, U[0,1) values at most 10 %
dense, but not on dense N(0,1) operands at K = 1024, where it measured
1.66x the gate (PERF.md, sections 6 and 7).

The GEMMs are `torch.matmul`, as the JAX package leaves them to XLA.  The
JAX marker trick (`_TINY`, `_densify_marked`, `_tiny_collision`,
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
from spmm_tpu_torch.utils.profiler import span

INDEX_DTYPE = prim.INDEX_DTYPE

# dense-intermediate auto-dispatch budget (bytes of dense temporaries)
_DENSE_BUDGET_BYTES = int(2e9)


PRECISIONS = ("highest", "high", "default")


@contextlib.contextmanager
def _fp32_matmul(mode: str):
    """float32 (and complex64) matmuls on the card in `mode`, "ieee" or
    "tf32", inside the block; the global setting is restored after.  The
    value GEMMs set it through `_value_matmul`."""
    mm = torch.backends.cuda.matmul
    old = mm.fp32_precision
    mm.fp32_precision = mode
    try:
        yield
    finally:
        mm.fp32_precision = old


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32
    with the low 13 mantissa bits clear."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with big + small = x to 22 bits: big is x rounded to
    TF32, small the remainder (exact in float32) rounded to TF32, so a TF32
    GEMM reads both as they are."""
    big = _tf32(x)
    return big, _tf32(x - big)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, out=None
                  ) -> torch.Tensor:
    """a @ b (float32, 2-D) as big·small + small·big + big·big of the
    `tf32_split` parts, the two small terms added first: three GEMMs whose
    operands are TF32 values, so a TF32 GEMM reads them exactly.  On the
    card `_value_matmul` runs it with TF32 on; on the CPU its IEEE GEMMs of
    the same operands emulate that arithmetic (the tests' float32
    emulation)."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    c = torch.matmul(a_big, b_small, out=out)
    c.addmm_(a_small, b_big)
    return c.addmm_(a_big, b_big)


def _value_matmul(a: torch.Tensor, b: torch.Tensor,
                  precision: str = "highest", out=None) -> torch.Tensor:
    """The value GEMM a @ b (one dtype; 2-D, or 3-D as a batch) in
    `precision` (module docstring): on the card, float32 "default" is one
    TF32 pass and "high" the 3xTF32 split (2-D only); everything else is
    one GEMM with TF32 off, which every other dtype takes in every mode.
    On the CPU every mode is one plain GEMM."""
    if a.device.type != "cuda":
        return torch.matmul(a, b, out=out)
    if a.dtype == torch.float32 and precision == "default":
        with _fp32_matmul("tf32"):
            return torch.matmul(a, b, out=out)
    if a.dtype == torch.float32 and precision == "high":
        with _fp32_matmul("tf32"):
            return tf32x3_matmul(a, b, out)
    with _fp32_matmul("ieee"):
        return torch.matmul(a, b, out=out)


def _alg1_dense_compute(a, b, alpha, precision: str = "highest"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense value and structural-pattern products; returns (alpha*C, mask,
    nnz) with nnz a 0-d int64 tensor on the operands' device.  A and B hold
    one dtype."""
    _check_precision(precision)
    m, k = a.shape
    n = b.shape[1]
    ad, a_pat = densify_onehot(a.indptr, a.indices, a.data, m, k)
    bd, b_pat = densify_onehot(b.indptr, b.indices, b.data, k, n)
    c = _value_matmul(ad, bd, precision)
    del ad, bd
    # bf16 0/1 terms: every partial sum is a positive count or 0, so
    # `> 0` is exact even where the bf16 GEMM rounds its sums or reduces
    # in reduced precision (allow_bf16_reduced_precision_reduction)
    counts = torch.matmul(a_pat, b_pat)
    mask = counts > 0
    nnz = mask.sum()
    alpha = prim.scalar_as(alpha, c.dtype)
    if alpha != 1:
        c.mul_(alpha)
    return c, mask, nnz


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (expected one of "
                         f"{PRECISIONS})")


def _dense_extract(c, mask, nnz: int):
    """Compaction of the kept cells; one kernel for every hole count."""
    return extract_roll(c, mask, nnz)


def _spgemm_alg1(a, b, alpha, precision: str = "highest"):
    from spmm_tpu_torch.sparse.csr import CSR

    m = a.shape[0]
    n = b.shape[1]
    c, mask, nnz_dev = _alg1_dense_compute(a, b, alpha, precision)
    nnz = prim.read_host(nnz_dev, "nnz")  # the analogue of spMatGetSize
    indptr, col, data = _dense_extract(c, mask, nnz)
    return CSR._wrap(indptr, col, data, (m, n), canonical=True)


def _alg1_fixed(a, b, alpha, cap: int, precision: str = "highest"):
    """ALG1 with a static output capacity and no host sync: (indptr, col,
    data, nnz) with `col`/`data` of length `cap`, zero past nnz, and indptr
    clamped to `cap` so the padded container stays self-consistent even
    when cap < nnz."""
    c, mask, nnz = _alg1_dense_compute(a, b, alpha, precision)
    indptr, col, data = extract_roll(c, mask, cap)
    return torch.clamp(indptr, max=cap), col, data, nnz


def _check_operands(a, b):
    """A and B checked, promoted to their common dtype where they differ
    (as JAX's `jnp.promote_types`, the reference's `_cast_common_type`)."""
    from spmm_tpu_torch.sparse.csr import CSR

    if not isinstance(a, CSR) or not isinstance(b, CSR):
        raise TypeError("spgemm expects CSR matrices (csr @ csr), matching "
                        "cusparse.spgemm validation")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and "
                         f"{b.device}")
    if a.dtype != b.dtype:
        common = torch.promote_types(a.dtype, b.dtype)
        a, b = a.astype(common), b.astype(common)
    return a, b


# ===========================================================================
# ALG2 — expand-sort-compress with exact two-phase sizing
# ===========================================================================


def _check_products(P: int, what: str) -> None:
    """The product workspace is indexed with int32, as in JAX, whose int32
    `ends` wraps past 2^31 products; here the count is int64 and the
    workspace refuses instead."""
    if P >= 2**31:
        raise ValueError(
            f"spgemm ESC: {what} holds {P} intermediate products, past the "
            "2^31 an int32-indexed workspace holds; use alg=3 with a "
            "chunk_fraction that keeps each chunk below 2^31")


def _work_estimation(a_indices, b_indptr):
    """Per-A-entry product counts and their inclusive prefix, both int64
    (symbolic phase; the analogue of `spGEMM_workEstimation`)."""
    ai = a_indices.long()
    counts = (b_indptr[ai + 1] - b_indptr[ai]).long()
    return counts, torch.cumsum(counts, 0)


def _expand_slots(a_indices, b_indptr, counts, ends, P: int):
    """(A entry, B position) of each of the P product slots, int32, in
    A-entry then B-row order."""
    dev = a_indices.device
    eid = torch.repeat_interleave(
        torch.arange(a_indices.numel(), dtype=INDEX_DTYPE, device=dev),
        counts, output_size=P)
    heads = (ends - counts).to(INDEX_DTYPE)
    within = torch.arange(P, dtype=INDEX_DTYPE, device=dev) - heads[eid]
    return eid, b_indptr[a_indices.long()][eid] + within


def _expand(a_rows, a_indices, a_data, b_indptr, b_indices, b_data,
            counts, ends, P: int):
    """Materialise all P partial products as (row, col, val) triplets.

    Expansion order is A-entry order then B-row order, fixed, so the
    downstream stable sort gives a deterministic duplicate order.  The JAX
    version rebuilds the per-entry quantities with delta scatters and a
    cumsum because TPU gathers serialise; the card gathers directly."""
    eid, b_pos = _expand_slots(a_indices, b_indptr, counts, ends, P)
    return a_rows[eid], b_indices[b_pos], a_data[eid] * b_data[b_pos]


def _expand_joined(a_rows, a_indices, a_data, b_indptr, b_indices, b_data,
                   counts, ends, P: int, k: int):
    """The same P triplets in B-position order (a stable sort of the slots
    by B position), as JAX's gather-free sort-join expansion returns them.
    For equal (row, col) both orders run over ascending k, so the
    downstream lexsort and tree give `_expand`'s bits.  `k` is kept for
    signature parity; the JAX version sizes a column count with it."""
    del k
    eid, b_pos = _expand_slots(a_indices, b_indptr, counts, ends, P)
    order = torch.sort(b_pos, stable=True).indices
    eid, b_pos = eid[order], b_pos[order]
    return a_rows[eid], b_indices[b_pos], a_data[eid] * b_data[b_pos]


def _compress(row_s, col_s, val_s, alpha, nnz_c: int, m: int):
    """Sum duplicate (row, col) runs with the fixed doubling tree; CSR
    (indptr, col, alpha * sums)."""
    out_row, out_col, out_val = _chunk_extract(row_s, col_s, val_s, alpha,
                                               nnz_c)
    return prim.build_indptr(out_row, m), out_col, out_val


def _esc_expand_sort_count(a_rows, a_indices, a_data,
                           b_indptr, b_indices, b_data,
                           counts, ends, P: int, m: int, n: int,
                           k: int = 0, joined: bool = False):
    """ESC numeric front half: expand all P partial products, stable-lexsort
    by (row, col), count distinct pairs (a 0-d tensor; no host sync)."""
    if joined:
        row, col, val = _expand_joined(a_rows, a_indices, a_data, b_indptr,
                                       b_indices, b_data, counts, ends, P, k)
    else:
        row, col, val = _expand(a_rows, a_indices, a_data, b_indptr,
                                b_indices, b_data, counts, ends, P)
    row_s, col_s, (val_s,) = prim.lexsort_rowcol(row, col, (val,), (m, n))
    return row_s, col_s, val_s, prim.count_unique_sorted(row_s, col_s)


def _empty_csr(m: int, n: int, dtype, device):
    from spmm_tpu_torch.sparse.csr import CSR

    return CSR._wrap(torch.zeros(m + 1, dtype=INDEX_DTYPE, device=device),
                     torch.zeros(0, dtype=INDEX_DTYPE, device=device),
                     torch.zeros(0, dtype=dtype, device=device), (m, n),
                     canonical=True)


def _spgemm_alg2_esc(a, b, alpha, joined: bool = False):
    from spmm_tpu_torch.sparse.csr import CSR

    m, k = a.shape
    n = b.shape[1]
    if a.nnz == 0 or b.nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    counts, ends = _work_estimation(a.indices, b.indptr)
    P = prim.read_host(ends[-1], "products")  # sizing (workEstimation)
    if P == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    _check_products(P, "alg=2")
    row_s, col_s, val_s, nnz_dev = _esc_expand_sort_count(
        a.rows, a.indices, a.data, b.indptr, b.indices, b.data,
        counts, ends, P, m, n, k, joined)
    nnz_c = prim.read_host(nnz_dev, "nnz")  # spMatGetSize
    indptr, out_col, out_val = _compress(row_s, col_s, val_s, alpha, nnz_c,
                                         m)
    return CSR._wrap(indptr, out_col, out_val, (m, n), canonical=True)


# ===========================================================================
# ALG3 — chunked ESC (bounded workspace)
# ===========================================================================


def _chunk_esc(a_indices, a_data, a_rows, b_indptr, b_indices, b_data,
               e0: int, e1: int, pw: int, m: int, n: int):
    """One ESC pass over the A entries [e0, e1) of a row chunk, whose pw
    products are known on the host: the sorted triplets and the chunk's
    distinct count (0-d).  The JAX version pads every chunk to the widest
    one (W products, sentinel rows) because XLA shapes are static; here
    each chunk holds only its own triplets."""
    counts, ends = _work_estimation(a_indices[e0:e1], b_indptr)
    row, col, val = _expand(a_rows[e0:e1], a_indices[e0:e1], a_data[e0:e1],
                            b_indptr, b_indices, b_data, counts, ends, pw)
    row_s, col_s, (val_s,) = prim.lexsort_rowcol(row, col, (val,), (m, n))
    return row_s, col_s, val_s, prim.count_unique_sorted(row_s, col_s)


def _chunk_extract(row_s, col_s, val_s, alpha, nnz_c: int):
    """(row, col, alpha * sum) of each of the nnz_c runs of sorted
    triplets, each run summed with the fixed doubling tree."""
    r, c, v = prim.sum_duplicates_sorted_tree(row_s, col_s, val_s, nnz_c)
    return r, c, v * prim.scalar_as(alpha, v.dtype)


def _alg3_esc_count(a, b, chunk_meta, m: int, n: int) -> torch.Tensor:
    """Sizing sweep: one ESC chunk live at a time; per-chunk distinct
    counts stay on the device for one readback (the workEstimation
    sweep)."""
    counts = torch.zeros(len(chunk_meta), dtype=torch.int64,
                         device=a.device)
    a_rows = a.rows
    for i, (_, _, e0, e1, pw) in enumerate(chunk_meta):
        if pw:
            *_, nnz_c = _chunk_esc(a.indices, a.data, a_rows, b.indptr,
                                   b.indices, b.data, e0, e1, pw, m, n)
            counts[i] = nnz_c
    return counts


def _alg3_esc_compute(a, b, chunk_meta, counts_h, alpha, m: int, n: int,
                      total: int):
    """Numeric sweep: recompute each chunk (cuSPARSE's staged pipeline also
    runs estimate + compute) and write its compacted output at its exact
    offset; the workspace stays one chunk + the output buffers."""
    row = torch.empty(total, dtype=INDEX_DTYPE, device=a.device)
    col = torch.empty(total, dtype=INDEX_DTYPE, device=a.device)
    val = torch.empty(total, dtype=a.dtype, device=a.device)
    a_rows = a.rows
    off = 0
    for (_, _, e0, e1, pw), cnt in zip(chunk_meta, counts_h.tolist()):
        if not cnt:
            continue
        row_s, col_s, val_s, _ = _chunk_esc(
            a.indices, a.data, a_rows, b.indptr, b.indices, b.data,
            e0, e1, pw, m, n)
        r, c, v = _chunk_extract(row_s, col_s, val_s, alpha, cnt)
        row[off:off + cnt], col[off:off + cnt], val[off:off + cnt] = r, c, v
        off += cnt
    return prim.build_indptr(row, m), col, val


def _spgemm_alg3_esc(a, b, alpha, chunk_fraction: float,
                     verbose: bool = False):
    from spmm_tpu_torch.sparse.csr import CSR

    m = a.shape[0]
    n = b.shape[1]
    if a.nnz == 0 or b.nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    _, ends = _work_estimation(a.indices, b.indptr)
    # one host read of indptr and the products through each row (whose
    # last entry is P): the sizing readback
    ip = a.indptr[1:].long()
    row_prod = torch.where(ip > 0, ends[(ip - 1).clamp(min=0)], 0)
    indptr_h, row_prod_cum = prim.read_host(torch.stack([ip, row_prod]),
                                            "row_products").numpy()
    indptr_h = np.concatenate([[0], indptr_h])
    P = int(row_prod_cum[-1])
    if P == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    chunk_fraction = min(max(float(chunk_fraction), 1e-3), 1.0)
    target = max(1, int(np.ceil(P * chunk_fraction)))
    # row boundaries balancing products per chunk (host, numpy)
    bounds = [0]
    while bounds[-1] < m:
        tgt = (row_prod_cum[bounds[-1] - 1] if bounds[-1] else 0) + target
        nxt = int(np.searchsorted(row_prod_cum, tgt, side="left")) + 1
        bounds.append(min(max(nxt, bounds[-1] + 1), m))
    chunk_meta = []
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        e0, e1 = int(indptr_h[r0]), int(indptr_h[r1])
        pw = int((row_prod_cum[r1 - 1] if r1 > 0 else 0)
                 - (row_prod_cum[r0 - 1] if r0 > 0 else 0))
        chunk_meta.append((r0, r1, e0, e1, pw))
    E = max(max(c[3] - c[2] for c in chunk_meta), 1)
    W = max(max(c[4] for c in chunk_meta), 1)
    _check_products(W, "an alg=3 chunk")
    if verbose:
        print(f"[spgemm alg3] P={P} chunks={len(chunk_meta)} "
              f"E={E} W={W} chunk_fraction={chunk_fraction}")
    counts_c = _alg3_esc_count(a, b, chunk_meta, m, n)
    # ONE sizing readback for all chunks
    counts_h = prim.read_host(counts_c, "chunk_counts").numpy()
    total = int(counts_h.sum())
    if total == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    indptr, col, val = _alg3_esc_compute(a, b, chunk_meta, counts_h, alpha,
                                         m, n, total)
    return CSR._wrap(indptr, col, val, (m, n), canonical=True)


# ===========================================================================
# public entry
# ===========================================================================


def _blocked_feasible(a, b) -> bool:
    """Dense-tile strategies apply when A/B dense panels fit the budget
    (the same regime class as alg1's intermediates)."""
    m, k = a.shape
    n = b.shape[1]
    return (4 * (m * k + k * n) <= _DENSE_BUDGET_BYTES
            and (m + 256) * (n + 256) < 2**31)


def _check_alg(alg: int, impl: str) -> None:
    if alg not in (0, 1, 2, 3):
        raise ValueError(f"unknown alg {alg!r} (expected 0, 1, 2 or 3)")
    if impl not in ("auto", "dense", "esc"):
        raise ValueError(f"unknown impl {impl!r}")


def _dense_bytes(a, b) -> int:
    """alg1's dense temporaries: A, B and two m x n products, 4 B each."""
    m, k = a.shape
    n = b.shape[1]
    return 4 * (m * k + k * n + 2 * m * n)


def _route(a, b, alg: int, impl: str) -> Tuple[str, int]:
    """Where `spgemm` sends canonical operands: ("alg1", 1), ("blocked",
    alg) or ("esc", alg), alg 0 resolved by the dense budget."""
    if alg in (0, 1):
        if alg == 1 or _dense_bytes(a, b) <= _DENSE_BUDGET_BYTES:
            return "alg1", 1
        alg = 2
    use_blocked = (impl == "dense"
                   or (impl == "auto" and _blocked_feasible(a, b)))
    return ("blocked" if use_blocked and a.nnz and b.nnz else "esc"), alg


def spgemm(a, b, alpha=1.0, alg: int = 0, chunk_fraction: float = 0.2,
           verbose: bool = False, precision: str = "highest",
           impl: str = "auto"):
    """C = alpha * A @ B, both CSR, as a canonical CSR on the operands'
    device.  API of the modified `cupyx.cusparse.spgemm` (cusparse.py:2007):
    alg 1 is the dense-intermediate path; 0 takes it when the dense
    temporaries fit `_DENSE_BUDGET_BYTES`, else alg 2; `chunk_fraction`
    applies to alg 3.

    `impl` selects the alg2/alg3 engine as in the JAX package: "dense"
    and, where A/B dense panels fit the budget, "auto" run the blocked
    dense engines (`ops/spgemm_blocked.py`) when both operands have
    entries; "esc" and every other case run expand-sort-compress.
    `spgemm_engine` names the engine a call runs.

    A call is the root span `spgemm`, its engine the child span
    `spgemm.alg1`, `spgemm.alg2.blocked`, `spgemm.alg3.blocked`,
    `spgemm.alg2.esc` or `spgemm.alg3.esc` (`utils/profiler.span`)."""
    with span("spgemm"):
        a, b = _check_operands(a, b)
        _check_alg(alg, impl)
        _check_precision(precision)
        a = a.sum_duplicates()
        b = b.sum_duplicates()
        route, resolved = _route(a, b, alg, impl)
        if route == "alg1":
            if verbose:
                print(f"[spgemm] alg1 dense-intermediate "
                      f"({_dense_bytes(a, b)} B)")
            with span("spgemm.alg1"):
                return _spgemm_alg1(a, b, alpha, precision)
        if verbose and alg == 0:
            print("[spgemm] auto: dense footprint too large → alg2")
        if route == "blocked":
            from spmm_tpu_torch.ops import spgemm_blocked as blocked

            if resolved == 2:
                with span("spgemm.alg2.blocked"):
                    return blocked.spgemm_alg2_blocked(a, b, alpha,
                                                       precision, verbose)
            with span("spgemm.alg3.blocked"):
                return blocked.spgemm_alg3_blocked(a, b, alpha,
                                                   chunk_fraction,
                                                   precision, verbose)
        if resolved == 2:
            with span("spgemm.alg2.esc"):
                return _spgemm_alg2_esc(a, b, alpha)
        with span("spgemm.alg3.esc"):
            return _spgemm_alg3_esc(a, b, alpha, chunk_fraction, verbose)


def spgemm_engine(a, b, alg: int = 0, chunk_fraction: float = 0.2) -> str:
    """The engine `spgemm(a, b, alg=alg, chunk_fraction=chunk_fraction)`
    runs, by the rules its dispatch follows (`_route`,
    `spgemm_blocked.alg2_engine`, `spgemm_blocked.alg3_engine`): "alg1",
    "esc", alg2's "unrolled" or "scan", or alg3's "group", "unrolled",
    "scan3" or "scan2".  It computes no product; alg3's blocked rule reads
    the operands' indices to the host."""
    a, b = _check_operands(a, b)
    _check_alg(alg, "auto")
    a = a.sum_duplicates()
    b = b.sum_duplicates()
    route, alg = _route(a, b, alg, "auto")
    if route != "blocked":
        return route
    from spmm_tpu_torch.ops import spgemm_blocked as blocked

    if alg == 2:
        return blocked.alg2_engine(a.shape[0])
    return blocked.alg3_engine(a, b, chunk_fraction)


def spgemm_fixed(a, b, alpha=1.0, cap: Optional[int] = None,
                 precision: str = "highest"):
    """(CSR padded to `cap`, true nnz as a 0-d tensor).  `cap` defaults to
    the exact output nnz, found by one sizing pass.  Raises if `cap` is
    smaller than the true nnz."""
    from spmm_tpu_torch.sparse.csr import CSR

    a, b = _check_operands(a, b)
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
    return CSR._wrap(indptr, col, data, (m, n), canonical=True), nnz


def spgemm_nnz_estimate(a, b) -> Tuple[int, int]:
    """(intermediate products P, upper bound on nnz(C)), in host int64."""
    if not a.nnz or not b.nnz:
        return 0, 0
    lens = np.diff(b.indptr.cpu().numpy()).astype(np.int64)
    P = int(lens[a.indices.cpu().numpy()].sum())
    return P, min(P, a.shape[0] * b.shape[1])
