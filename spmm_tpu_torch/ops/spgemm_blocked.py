"""Blocked dense-intermediate SpGEMM: the alg2 and alg3 engines.

Port of `spmm_tpu/ops/spgemm_blocked.py`, engine for engine, with JAX's
selection rules and constants, so the same inputs take the same engine:

  alg2 (balanced): a symbolic phase densifies the A and B patterns
      (kernel `densify_onehot_pattern`) and runs one bf16 count GEMM per
      128-row tile, giving the (m_pad, n) structural mask and the per-tile
      counts; one host readback sizes the output (the `spMatGetSize`
      analogue).  The numeric phase densifies B once (values only) and, per
      tile, the A tile, runs one value GEMM and compacts the tile under
      its mask slice (kernel `extract_roll`).  Past
      `_ALG2_MAX_UNROLL_TILES` tiles the scan engine densifies A and B
      whole and recounts each tile itself; both give the same bits.

  alg3 (chunked): nothing is ever fully dense.  B is cut into column
      panels of width n_b (from `chunk_fraction`, clamped to [1e-3, 1]) and
      A into 128-row tiles; every (tile, panel) block runs the same step,
      `_block`: densify the A tile (values and pattern), one value GEMM
      and one bf16 count GEMM against the densified panel, and the mask.
      Four engines assemble the blocks into CSR and differ in nothing else,
      so they agree bitwise: `group` (G tiles staged as full-width value
      and mask stripes, extracted in final order), `unrolled` (per-block
      compaction, per-tile merge sort), `scan3` (per-block compaction into
      a production buffer, one gather into final order) and `scan2` (device
      sizing pass, then per-block compaction and per-tile merge).  The first
      three take the output structure from the host structural product, as
      JAX does.

The value GEMMs are `spgemm._value_matmul` in the `precision` asked for
(JAX: `jnp.dot(..., precision=)`), in the operands' dtype; the sorts are
stable `torch.sort` (JAX: `lax.sort`).  JAX's densify helpers (`_densify_pair`,
`_densify_pattern`, `_pattern_dense`, `_value_dense`) are the kernel
wrappers `densify_onehot` and `densify_onehot_pattern`, which run their
plain versions on CPU tensors; alpha, rounded to A's dtype, is folded into
each write as one multiply, as JAX folds it.  Sizes that steer the Python loops are read
on the host once per call, so the host syncs of a call do not grow with
the number of tiles T or panels P.  Every block's workspace is dropped
before the next block, so the peak holds one block's workspace.

Not ported, because they only serve the TPU or XLA: the
`optimization_barrier` tokens and opaque-zero chains (they steer XLA's
scheduling and CSE; a Python loop runs in order), the `_TINY` marker and
`safe` (the CUDA densify writes the pattern from the structure itself), the
one-hot plans (`_plan_for`, `_onehot_plans_padded`, `_tile_onehot_plan`;
the CUDA kernels take none), the rank sort used in place of a gather (the
card gathers), the entry-stream scatters of the scan engines (the port
densifies the same tile and panel CSRs with the kernel), and
`memtrace.jit`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.densify_onehot import (densify_onehot,
                                                       densify_onehot_pattern)
from spmm_tpu_torch.ops.kernels.extract_roll import extract_roll
from spmm_tpu_torch.ops.serving import _structural_product
from spmm_tpu_torch.ops.spgemm import _empty_csr, _value_matmul

INDEX_DTYPE = prim.INDEX_DTYPE
TILE = 128

# engine bounds, JAX's values (spmm_tpu/ops/spgemm_blocked.py)
_ALG2_MAX_UNROLL_TILES = 32
_FAST_COUNT_BUDGET = int(1e9)
MAX_UNROLL_BLOCKS = 48
_SCAN3_MAX_TILES = 32
_SCAN3_MAX_PRODUCTS = int(2.5e9)
_GROUP_STAGING_BYTES = 8 << 20
_GROUP_MAX_BLOCKS = 96
_ENGINES = ("group", "unrolled", "scan3", "scan2")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_indptr_h(indptr_h, m_pad: int):
    if m_pad > indptr_h.shape[0] - 1:
        indptr_h = np.concatenate(
            [indptr_h,
             np.full((m_pad - (indptr_h.shape[0] - 1),),
                     indptr_h[-1], indptr_h.dtype)])
    return indptr_h


def _pad_indptr(indptr: torch.Tensor, m_pad: int) -> torch.Tensor:
    """indptr of m_pad rows on the device, the extra rows empty."""
    extra = m_pad - (indptr.numel() - 1)
    if extra <= 0:
        return indptr
    return torch.cat([indptr, indptr[-1:].expand(extra)])


def _tile(indptr_pad, indptr_pad_h, indices, data, t: int):
    """CSR (indptr, indices, data) of row tile t, or None when it is empty:
    views of A's arrays and a rebased indptr."""
    e0 = int(indptr_pad_h[t * TILE])
    e1 = int(indptr_pad_h[(t + 1) * TILE])
    if e1 == e0:
        return None
    ipt = indptr_pad[t * TILE:(t + 1) * TILE + 1] - e0
    return ipt, indices[e0:e1], (None if data is None else data[e0:e1])


# ===========================================================================
# ALG2 — row-tile streamed, B dense once
# ===========================================================================


def _alg2_count(a_indptr, a_indices, b_indptr, b_indices, m_pad: int,
                k: int, n: int, T: int):
    """Symbolic phase (the workEstimation analogue): (rowc (m_pad,),
    tilec (T,), mask (m_pad, n) bool) from the padded A and the B pattern,
    one bf16 count GEMM per tile.  The counts are bf16: every partial sum is
    a positive count or 0, so `> 0` is exact (`spgemm._alg1_dense_compute`).
    JAX's signature also takes the values, which it does not read."""
    a_pat = densify_onehot_pattern(a_indptr, a_indices, m_pad, k)
    b_pat = densify_onehot_pattern(b_indptr, b_indices, k, n)
    mask = torch.empty((m_pad, n), dtype=torch.bool, device=b_pat.device)
    for t in range(T):
        rows = slice(t * TILE, (t + 1) * TILE)
        torch.gt(torch.matmul(a_pat[rows], b_pat), 0, out=mask[rows])
    del a_pat, b_pat
    rowc = mask.sum(1, dtype=INDEX_DTYPE)
    tilec = rowc.view(T, TILE).sum(1, dtype=INDEX_DTYPE)
    return rowc, tilec, mask


def _indptr_from_rowc(rowc: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(1, dtype=INDEX_DTYPE, device=rowc.device)
    return torch.cat([zero, torch.cumsum(rowc, 0, dtype=INDEX_DTYPE)])


def _alg2_compute_unrolled(a_indptr_pad, a_indptr_pad_h, a_indices, a_data,
                           b_indptr, b_indices, b_data, mask, alpha, m: int,
                           k: int, n: int, T: int, nnz: int, tile_caps,
                           precision: str = "highest"):
    """Numeric phase for T <= _ALG2_MAX_UNROLL_TILES: A is never fully
    dense.  B is densified once (values only); each tile densifies its A
    rows (values only), multiplies the dense B, compacts under its slice of
    the symbolic mask with its exact count and writes at its offset.
    Returns (indptr, cols, alpha * vals)."""
    bd, _ = densify_onehot(b_indptr, b_indices, b_data, k, n,
                           with_pattern=False)
    cols = torch.zeros(nnz, dtype=INDEX_DTYPE, device=bd.device)
    vals = torch.zeros(nnz, dtype=bd.dtype, device=bd.device)
    off = 0
    for t in range(T):
        cap_t = min(tile_caps[t], nnz - off)
        tile = _tile(a_indptr_pad, a_indptr_pad_h, a_indices, a_data, t)
        if tile is None or cap_t == 0:
            continue
        ad, _ = densify_onehot(*tile, TILE, k, with_pattern=False)
        ct = _value_matmul(ad, bd, precision)
        del ad
        _, cols_t, vals_t = extract_roll(ct, mask[t * TILE:(t + 1) * TILE],
                                         cap_t)
        del ct
        cols[off:off + cap_t] = cols_t
        torch.mul(vals_t, alpha, out=vals[off:off + cap_t])
        del cols_t, vals_t
        off += cap_t
    return _indptr_from_rowc(mask[:m].sum(1, dtype=INDEX_DTYPE)), cols, vals


def _alg2_compute(a_indptr_pad, a_indices, a_data, b_indptr, b_indices,
                  b_data, alpha, tilec_h, m: int, m_pad: int, k: int, n: int,
                  T: int, cap_tile: int, nnz: int,
                  precision: str = "highest"):
    """Scan-engine numeric phase (T > _ALG2_MAX_UNROLL_TILES): A and B
    densified whole (values and patterns); each tile recounts its own
    structure, compacts cap_tile slots and writes them at its running
    offset, where the next tile overwrites the padding.  Bitwise equal to
    `_alg2_compute_unrolled` (the same tile GEMM, the same mask)."""
    ad, a_pat = densify_onehot(a_indptr_pad, a_indices, a_data, m_pad, k)
    bd, b_pat = densify_onehot(b_indptr, b_indices, b_data, k, n)
    dev = bd.device
    offs = np.concatenate([[0], np.cumsum(tilec_h)])
    colbuf = torch.zeros(nnz + cap_tile, dtype=INDEX_DTYPE, device=dev)
    valbuf = torch.zeros(nnz + cap_tile, dtype=bd.dtype, device=dev)
    rowc = torch.zeros(m_pad, dtype=INDEX_DTYPE, device=dev)
    for t in range(T):
        if not tilec_h[t]:
            continue  # nothing to write; later tiles cover the slots
        rows = slice(t * TILE, (t + 1) * TILE)
        ct = _value_matmul(ad[rows], bd, precision)
        mask = torch.matmul(a_pat[rows], b_pat) > 0
        _, cols_t, vals_t = extract_roll(ct, mask, cap_tile)
        o = int(offs[t])
        colbuf[o:o + cap_tile] = cols_t
        torch.mul(vals_t, alpha, out=valbuf[o:o + cap_tile])
        torch.sum(mask, 1, dtype=INDEX_DTYPE, out=rowc[rows])
        del ct, mask, cols_t, vals_t
    return _indptr_from_rowc(rowc[:m]), colbuf[:nnz], valbuf[:nnz]


def alg2_engine(m: int) -> str:
    """The engine `spgemm_alg2_blocked` runs for an A of `m` rows:
    "unrolled" up to `_ALG2_MAX_UNROLL_TILES` row tiles, else "scan"."""
    T = _round_up(max(m, 1), TILE) // TILE
    return "unrolled" if T <= _ALG2_MAX_UNROLL_TILES else "scan"


def spgemm_alg2_blocked(a, b, alpha, precision: str = "highest",
                        verbose: bool = False):
    """Balanced blocked SpGEMM; see the module docstring."""
    from spmm_tpu_torch.sparse.csr import CSR

    m, k = a.shape
    n = b.shape[1]
    alpha = prim.scalar_as(alpha, a.dtype)
    m_pad = _round_up(max(m, 1), TILE)
    T = m_pad // TILE
    (a_indptr_h,) = prim.to_host(a.indptr, what="indptr")
    a_indptr_h = _pad_indptr_h(a_indptr_h, m_pad)
    a_indptr = _pad_indptr(a.indptr, m_pad)
    rowc, tilec, mask = _alg2_count(a_indptr, a.indices, b.indptr, b.indices,
                                    m_pad, k, n, T)
    del rowc
    # sizing readback (spMatGetSize)
    (tilec_h,) = prim.to_host(tilec, what="tile_counts")
    nnz = int(tilec_h.sum())
    if nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    if alg2_engine(m) == "unrolled":
        if verbose:
            print(f"[spgemm alg2/blocked] unrolled T={T} nnz={nnz}")
        indptr, cols, vals = _alg2_compute_unrolled(
            a_indptr, a_indptr_h, a.indices, a.data, b.indptr, b.indices,
            b.data, mask, alpha, m, k, n, T, nnz,
            [int(c) for c in tilec_h], precision)
        return CSR._wrap(indptr, cols, vals, (m, n), canonical=True)
    del mask  # the scan engine recounts each tile
    cap_tile = _round_up(int(tilec_h.max()), 8)
    if verbose:
        print(f"[spgemm alg2/blocked] T={T} cap_tile={cap_tile} nnz={nnz}")
    indptr, cols, vals = _alg2_compute(
        a_indptr, a.indices, a.data, b.indptr, b.indices, b.data, alpha,
        tilec_h, m, m_pad, k, n, T, cap_tile, nnz, precision)
    return CSR._wrap(indptr, cols, vals, (m, n), canonical=True)


# ===========================================================================
# ALG3 — tile x panel streamed, nothing fully dense
# ===========================================================================


class _Blocks:
    """A's row tiles and B's column panels, each a canonical CSR on the
    device, with their host bounds: what every alg3 engine densifies block
    by block.  B's entries are reordered panel-major (a stable sort by
    panel keeps each panel's rows and columns in order) with one gather of
    the values; the panels' indptrs and local columns are built on the host
    and sent in one copy."""

    def __init__(self, a, b, host, n_b: int, P: int, m_pad: int,
                 precision: str = "highest"):
        ai, _, bi, bj = host
        k = b.shape[0]
        self.a, self.k, self.n_b = a, k, n_b
        self.precision = precision
        self.a_indptr_h = _pad_indptr_h(ai, m_pad)
        self.a_indptr = _pad_indptr(a.indptr, m_pad)
        b_rows = np.repeat(np.arange(k, dtype=np.int64), np.diff(bi))
        panel_of = (bj // n_b).astype(np.int64)
        order = np.argsort(panel_of, kind="stable")
        self.b_bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(panel_of, minlength=P))])
        per_row = np.bincount(panel_of * k + b_rows,
                              minlength=P * k).reshape(P, k)
        b_ip = np.zeros((P, k + 1), np.int64)
        np.cumsum(per_row, axis=1, out=b_ip[:, 1:])
        ip_d, lcol_d, order_d = prim.to_device(
            b.device, b_ip, (bj % n_b)[order], order)
        self.b_indptr = ip_d.view(P, k + 1)
        self.b_lcol = lcol_d
        self.b_vals = b.data[order_d.long()]

    def tile(self, t: int, with_values: bool = True):
        return _tile(self.a_indptr, self.a_indptr_h, self.a.indices,
                     self.a.data if with_values else None, t)

    def panel_csr(self, p: int):
        """(indptr, local cols, values) of panel p, or None when empty."""
        b0, b1 = int(self.b_bounds[p]), int(self.b_bounds[p + 1])
        if b1 == b0:
            return None
        return self.b_indptr[p], self.b_lcol[b0:b1], self.b_vals[b0:b1]

    def panel(self, p: int):
        """Panel p densified, (k, n_b) values and bf16 pattern, or None
        when it is empty."""
        csr = self.panel_csr(p)
        return None if csr is None else densify_onehot(*csr, self.k, self.n_b)


def _block(tile, panel, k: int, precision: str = "highest"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step every alg3 engine runs per (tile, panel) block: densify the
    A tile (values and pattern), one value GEMM in `precision` and one bf16
    count GEMM against the densified panel; (ct (TILE, n_b), mask bool)."""
    ad, a_pat = densify_onehot(*tile, TILE, k)
    bd, b_pat = panel
    ct = _value_matmul(ad, bd, precision)
    return ct, torch.matmul(a_pat, b_pat) > 0


def _compact(ct, mask, cap: int):
    """A block's kept cells in row-major order, in `cap` slots: (local row
    int64, local col int32, value).  Slots past the block's count hold row
    TILE, so `row < TILE` marks the valid ones without a host read."""
    indptr, col, val = extract_roll(ct, mask, cap)
    slots = torch.arange(cap, dtype=INDEX_DTYPE, device=ct.device)
    row = torch.searchsorted(indptr[1:], slots, right=True)
    return row, col, val


def _alg3_host_structure(a, b, n_b: int, P: int, T: int):
    """Exact output indptr and per-(panel, tile) counts (P, T) on the host:
    the sizing analogue of the reference's estimateMemory/spMatGetSize,
    resolved at plan time like the serving path."""
    indptr_h, _, flat = _structural_product(a, b)
    n = b.shape[1]
    rows = flat // n
    cols = flat % n
    key = (cols // n_b) * T + rows // TILE
    blockc = np.bincount(key, minlength=P * T).reshape(P, T)
    return indptr_h, blockc


def _alg3_rank(a, b, n_b: int, T: int, n: int):
    """Host-exact structure and the production order: (indptr, indices,
    prod_order, blockc).  Production order is (panel, tile, local row,
    local col), the order scan3 writes block values in; prod_order[i] is the
    final (CSR) position of the i-th value produced."""
    indptr_h, indices_h, flat = _structural_product(a, b)
    rows = flat // n
    cols = flat % n
    p_of = cols // n_b
    t_of = rows // TILE
    lflat = (rows % TILE) * n_b + (cols % n_b)
    prod_order = np.lexsort((lflat, t_of, p_of))
    P = int(p_of.max()) + 1 if flat.size else 1
    blockc = np.bincount(p_of * T + t_of, minlength=P * T).reshape(P, T)
    return indptr_h, indices_h, prod_order.astype(np.int32), blockc


# ---------------------------------------------------------------------------
# group engine: staged full-width stripes, extraction in final order
# ---------------------------------------------------------------------------


def _alg3_compute_group(blocks: _Blocks, alpha, n: int, n_b: int, T: int,
                        P: int, G: int, nnz: int, tile_caps):
    """Stage G row tiles as (G*TILE, n) value and mask stripes: each panel's
    block lands at its final columns, so each tile's values come out in
    final CSR order with one `extract_roll` and no sort.  B panels are
    densified again for every group (the time-memory knob)."""
    k = blocks.k
    offs = np.concatenate([[0], np.cumsum(tile_caps)])
    dev = blocks.b_vals.device
    vals = torch.zeros(nnz, dtype=blocks.b_vals.dtype, device=dev)
    for g0 in range(0, T, G):
        Gt = min(G, T - g0)
        if not any(tile_caps[g0:g0 + Gt]):
            continue
        stage_v = torch.zeros((Gt * TILE, n), dtype=vals.dtype, device=dev)
        stage_m = torch.zeros((Gt * TILE, n), dtype=torch.bool, device=dev)
        for p in range(P):
            panel = blocks.panel(p)
            if panel is None:
                continue
            c0 = p * n_b
            w = min(n_b, n - c0)
            for ti in range(Gt):
                tile = blocks.tile(g0 + ti)
                if tile is None or tile_caps[g0 + ti] == 0:
                    continue
                ct, mask = _block(tile, panel, k, blocks.precision)
                rows = slice(ti * TILE, (ti + 1) * TILE)
                stage_v[rows, c0:c0 + w] = ct[:, :w]
                stage_m[rows, c0:c0 + w] = mask[:, :w]
                del ct, mask
            del panel
        for ti in range(Gt):
            t = g0 + ti
            cap_t = tile_caps[t]
            if cap_t == 0:
                continue
            rows = slice(ti * TILE, (ti + 1) * TILE)
            _, _, vals_t = extract_roll(stage_v[rows], stage_m[rows], cap_t)
            o = int(offs[t])
            torch.mul(vals_t, alpha, out=vals[o:o + cap_t])
            del vals_t
        del stage_v, stage_m
    return vals


def _spgemm_alg3_group(a, b, host, alpha, n_b: int, P: int, T: int,
                       m_pad: int, verbose: bool,
                       precision: str = "highest"):
    from spmm_tpu_torch.sparse.csr import CSR

    m = a.shape[0]
    n = b.shape[1]
    indptr_h, indices_h, _ = _structural_product(a, b)
    nnz = int(indptr_h[-1])
    if nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    bounds = np.minimum(np.arange(T + 1) * TILE, m)
    tile_caps = [int(indptr_h[bounds[t + 1]] - indptr_h[bounds[t]])
                 for t in range(T)]
    itemsize = a.data.element_size()
    G = max(1, min(T, _GROUP_STAGING_BYTES // (TILE * n * (itemsize + 1))))
    if verbose:
        print(f"[spgemm alg3/blocked] group T={T} P={P} n_b={n_b} G={G} "
              f"nnz={nnz}")
    blocks = _Blocks(a, b, host, n_b, P, m_pad, precision)
    vals = _alg3_compute_group(blocks, alpha, n, n_b, T, P, G, nnz,
                               tile_caps)
    indptr, indices = prim.to_device(a.device, indptr_h, indices_h)
    return CSR._wrap(indptr, indices, vals, (m, n), canonical=True)


# ---------------------------------------------------------------------------
# unrolled engine: per-block compaction, per-tile merge
# ---------------------------------------------------------------------------


def _alg3_compute_unrolled(blocks: _Blocks, blockc, alpha, n: int, n_b: int,
                           T: int, P: int, cap_blk: int, nnz: int):
    """Each block compacts to cap_blk slots keyed by its tile-local flat
    position (local row * n + global col; slots past its count key past
    the tile); a tile's P blocks are column-disjoint, so one stable sort
    per tile gives final CSR order.  Returns (cols, alpha * vals)."""
    k = blocks.k
    big = TILE * n
    parts = [[] for _ in range(T)]
    for p in range(P):
        panel = blocks.panel(p)
        if panel is None:
            continue
        for t in range(T):
            tile = blocks.tile(t)
            if tile is None or blockc[p, t] == 0:
                continue
            ct, mask = _block(tile, panel, k, blocks.precision)
            row, col, val = _compact(ct, mask, cap_blk)
            del ct, mask
            key = torch.where(row < TILE, row * n + col + p * n_b, big)
            parts[t].append((key, val))
            del row, col
        del panel
    tile_nnz = blockc.sum(axis=0)
    dev = blocks.b_vals.device
    cols = torch.zeros(nnz, dtype=INDEX_DTYPE, device=dev)
    vals = torch.zeros(nnz, dtype=blocks.b_vals.dtype, device=dev)
    off = 0
    for t in range(T):
        c = int(tile_nnz[t])
        if not parts[t]:
            continue
        keys, order = torch.sort(torch.cat([x for x, _ in parts[t]]),
                                 stable=True)
        vv = torch.cat([v for _, v in parts[t]])
        parts[t] = None
        cols[off:off + c] = keys[:c] % n
        torch.mul(vv[order[:c]], alpha, out=vals[off:off + c])
        del keys, order, vv
        off += c
    return cols, vals


def _spgemm_alg3_unrolled(a, b, host, alpha, n_b: int, P: int, T: int,
                          m_pad: int, verbose: bool,
                          precision: str = "highest"):
    from spmm_tpu_torch.sparse.csr import CSR

    m = a.shape[0]
    n = b.shape[1]
    indptr_h, blockc = _alg3_host_structure(a, b, n_b, P, T)
    nnz = int(indptr_h[-1])
    if nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    cap_blk = max(_round_up(int(blockc.max()), 8), 8)
    cap_tile = max(_round_up(int(blockc.sum(axis=0).max()), 8), 8)
    if verbose:
        print(f"[spgemm alg3/blocked] unrolled T={T} P={P} n_b={n_b} "
              f"cap_blk={cap_blk} cap_tile={cap_tile} nnz={nnz}")
    blocks = _Blocks(a, b, host, n_b, P, m_pad, precision)
    cols, vals = _alg3_compute_unrolled(blocks, blockc, alpha, n, n_b, T, P,
                                        cap_blk, nnz)
    (indptr,) = prim.to_device(a.device, indptr_h)
    return CSR._wrap(indptr, cols, vals, (m, n), canonical=True)


# ---------------------------------------------------------------------------
# scan3 engine: production buffer, one gather into final order
# ---------------------------------------------------------------------------


def _alg3_compute_scan3(blocks: _Blocks, blockc, prod_off, gather, alpha,
                        T: int, P: int, cap_blk: int, nnz: int):
    """Blocks in panel-major order write alpha * their compacted values at
    their exact production offsets (ascending, so each block overwrites the
    previous one's padding); one gather by the host-built inverse of the
    production order gives CSR order."""
    k = blocks.k
    dev = blocks.b_vals.device
    vbuf = torch.zeros(nnz + cap_blk, dtype=blocks.b_vals.dtype, device=dev)
    for p in range(P):
        panel = blocks.panel(p)
        if panel is None:
            continue
        for t in range(T):
            tile = blocks.tile(t)
            if tile is None or blockc[p, t] == 0:
                continue
            ct, mask = _block(tile, panel, k, blocks.precision)
            _, _, val = extract_roll(ct, mask, cap_blk)
            del ct, mask
            o = int(prod_off[p, t])
            torch.mul(val, alpha, out=vbuf[o:o + cap_blk])
            del val
        del panel
    return vbuf[gather.long()]


def _spgemm_alg3_scan3(a, b, host, alpha, n_b: int, P: int, T: int,
                       m_pad: int, verbose: bool,
                       precision: str = "highest"):
    from spmm_tpu_torch.sparse.csr import CSR

    m = a.shape[0]
    n = b.shape[1]
    indptr_h, indices_h, prod_order, blockc = _alg3_rank(a, b, n_b, T, n)
    nnz = int(indptr_h[-1])
    if nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    if blockc.shape[0] < P:  # trailing all-empty panels
        blockc = np.concatenate(
            [blockc, np.zeros((P - blockc.shape[0], T), blockc.dtype)])
    cap_blk = max(_round_up(int(blockc.max()), 8), 8)
    prod_off = np.zeros(P * T + 1, np.int64)
    np.cumsum(blockc.reshape(-1), out=prod_off[1:])
    prod_off = prod_off[:-1].reshape(P, T)
    gather = np.empty_like(prod_order)
    gather[prod_order] = np.arange(nnz, dtype=prod_order.dtype)
    if verbose:
        print(f"[spgemm alg3/blocked] scan3 T={T} P={P} n_b={n_b} "
              f"cap_blk={cap_blk} nnz={nnz}")
    blocks = _Blocks(a, b, host, n_b, P, m_pad, precision)
    indptr, indices, gather_d = prim.to_device(a.device, indptr_h, indices_h,
                                               gather)
    vals = _alg3_compute_scan3(blocks, blockc, prod_off, gather_d, alpha, T,
                               P, cap_blk, nnz)
    return CSR._wrap(indptr, indices, vals, (m, n), canonical=True)


# ---------------------------------------------------------------------------
# scan2 engine: device sizing pass, production buffer, per-tile merge
# ---------------------------------------------------------------------------


def _alg3_count_fast(blocks: _Blocks, b_indptr, b_indices, n_b: int,
                     T: int, P: int):
    """Sizing pass over a resident bf16 B pattern: per-row counts (m_pad,)
    and per-block counts (P, T), one count GEMM per tile.  The pattern is
    B's as a (k, P*n_b) matrix: the columns past n are empty, which is
    JAX's padding of the pattern to whole panels.  A's pattern is densified
    a tile at a time (JAX densifies it whole; the counts are the same)."""
    k = blocks.k
    b_pat = densify_onehot_pattern(b_indptr, b_indices, k, P * n_b)
    dev = b_pat.device
    rowc = torch.zeros(T * TILE, dtype=INDEX_DTYPE, device=dev)
    blockc = torch.zeros((T, P), dtype=INDEX_DTYPE, device=dev)
    for t in range(T):
        tile = blocks.tile(t, with_values=False)
        if tile is None:
            continue
        a_pat = densify_onehot_pattern(tile[0], tile[1], TILE, k)
        nz = torch.matmul(a_pat, b_pat) > 0
        del a_pat
        rows = slice(t * TILE, (t + 1) * TILE)
        torch.sum(nz, 1, dtype=INDEX_DTYPE, out=rowc[rows])
        torch.sum(nz.view(TILE, P, n_b), (0, 2), dtype=INDEX_DTYPE,
                  out=blockc[t])
        del nz
    return rowc, blockc.T


def _alg3_count(blocks: _Blocks, T: int, P: int):
    """Streamed sizing pass (past `_FAST_COUNT_BUDGET`): per panel, its
    pattern from its CSR, and per tile the tile's pattern and one count
    GEMM; nothing wider than a panel is dense.  JAX adds 1.0 per entry with
    a scatter and tests `> 0`; the pattern kernel writes the 1s directly."""
    k, n_b = blocks.k, blocks.n_b
    dev = blocks.b_vals.device
    rowc = torch.zeros(T * TILE, dtype=INDEX_DTYPE, device=dev)
    blockc = torch.zeros((P, T), dtype=INDEX_DTYPE, device=dev)
    for p in range(P):
        csr = blocks.panel_csr(p)
        if csr is None:
            continue
        b_pat = densify_onehot_pattern(csr[0], csr[1], k, n_b)
        for t in range(T):
            tile = blocks.tile(t, with_values=False)
            if tile is None:
                continue
            a_pat = densify_onehot_pattern(tile[0], tile[1], TILE, k)
            nz = torch.matmul(a_pat, b_pat) > 0
            del a_pat
            rowc_t = nz.sum(1, dtype=INDEX_DTYPE)
            rowc[t * TILE:(t + 1) * TILE] += rowc_t
            torch.sum(rowc_t, 0, dtype=INDEX_DTYPE, out=blockc[p, t])
            del nz, rowc_t
        del b_pat
    return rowc, blockc


def _alg3_compute(blocks: _Blocks, rowc, blockc_h, alpha, m: int, n: int,
                  n_b: int, T: int, P: int, cap_blk: int, nnz: int):
    """Numeric sweep and per-tile merge.  Each block compacts to cap_blk
    slots; its exact count (from the sizing readback) of keys (tile-local
    flat position) and values lands in a flat production buffer at its
    t-major offset.  Then each tile's segment is sorted by key, once, into
    CSR order.  indptr comes from the sizing pass's row counts."""
    k = blocks.k
    dev = blocks.b_vals.device
    tilec = blockc_h.sum(axis=0)
    offs = np.concatenate([[0], np.cumsum(tilec)])
    prod_off = np.concatenate([[0], np.cumsum(blockc_h.T.reshape(-1))])
    keybuf = torch.zeros(nnz, dtype=torch.int64, device=dev)
    pvalbuf = torch.zeros(nnz, dtype=blocks.b_vals.dtype, device=dev)
    for p in range(P):
        panel = blocks.panel(p)
        if panel is None:
            continue
        for t in range(T):
            nb = int(blockc_h[p, t])
            tile = blocks.tile(t)
            if tile is None or nb == 0:
                continue
            ct, mask = _block(tile, panel, k, blocks.precision)
            row, col, val = _compact(ct, mask, cap_blk)
            del ct, mask
            o = int(prod_off[t * P + p])
            keybuf[o:o + nb] = row[:nb] * n + col[:nb] + p * n_b
            pvalbuf[o:o + nb] = val[:nb]
            del row, col, val
        del panel
    cols = torch.empty(nnz, dtype=INDEX_DTYPE, device=dev)
    vals = torch.empty(nnz, dtype=pvalbuf.dtype, device=dev)
    for t in range(T):
        o0, o1 = int(offs[t]), int(offs[t + 1])
        if o1 == o0:
            continue
        keys, order = torch.sort(keybuf[o0:o1], stable=True)
        cols[o0:o1] = keys % n
        torch.mul(pvalbuf[o0:o1][order], alpha, out=vals[o0:o1])
        del keys, order
    return _indptr_from_rowc(rowc[:m]), cols, vals


def _spgemm_alg3_scan2(a, b, host, alpha, n_b: int, P: int, T: int,
                       m_pad: int, n_pad: int, verbose: bool,
                       precision: str = "highest"):
    from spmm_tpu_torch.sparse.csr import CSR

    m, k = a.shape
    n = b.shape[1]
    ai, _, _, bj = host
    if verbose:
        # JAX's entry-stream widths, for its verbose line
        a_starts = ai[np.minimum(np.arange(T) * TILE, m)]
        a_ends = ai[np.minimum(np.arange(1, T + 1) * TILE, m)]
        Ea = max(_round_up(int((a_ends - a_starts).max()), 8), 8)
        b_counts = np.bincount(bj // n_b, minlength=P)
        Eb = max(_round_up(int(b_counts.max()), 8), 8)
        print(f"[spgemm alg3/blocked] T={T} P={P} n_b={n_b} Ea={Ea} "
              f"Eb={Eb}")
    blocks = _Blocks(a, b, host, n_b, P, m_pad, precision)
    if 2 * k * n_pad <= _FAST_COUNT_BUDGET:
        rowc, blockc = _alg3_count_fast(blocks, b.indptr, b.indices, n_b, T,
                                        P)
    else:
        rowc, blockc = _alg3_count(blocks, T, P)
    blockc_h = prim.to_host(blockc.reshape(-1),  # sizing
                            what="block_counts")[0].reshape(P, T)
    nnz = int(blockc_h.sum())
    if nnz == 0:
        return _empty_csr(m, n, a.dtype, a.device)
    cap_blk = max(_round_up(int(blockc_h.max()), 8), 8)
    indptr, cols, vals = _alg3_compute(blocks, rowc, blockc_h, alpha, m, n,
                                       n_b, T, P, cap_blk, nnz)
    return CSR._wrap(indptr, cols, vals, (m, n), canonical=True)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def _alg3_grid(m: int, n: int, chunk_fraction: float):
    """(n_b, P, n_pad, m_pad, T): JAX's panel-width rule for
    `chunk_fraction` (clamped to [1e-3, 1], the `estimateMemory` knob) and
    the tile count."""
    chunk_fraction = min(max(float(chunk_fraction), 1e-3), 1.0)
    n_pad = _round_up(n, 128)
    n_b = min(max(_round_up(int(np.ceil(chunk_fraction * n)), 128), 128),
              n_pad)
    P = n_pad // n_b if n_pad % n_b == 0 else -(-n_pad // n_b)
    n_b = n_pad // P if n_pad % P == 0 else n_b
    P = -(-n_pad // n_b)
    m_pad = _round_up(max(m, 1), TILE)
    return n_b, P, n_pad, m_pad, m_pad // TILE


def select_alg3_engine(nnz_a: int, nnz_b: int, products: int, T: int,
                       P: int, n_pad: int) -> str:
    """JAX's engine rule: group (host-exact structure, T*P within
    `_GROUP_MAX_BLOCKS`), unrolled (T*P within `MAX_UNROLL_BLOCKS`), scan3
    (host-exact structure, T within `_SCAN3_MAX_TILES`), else scan2."""
    keys_fit = TILE * (n_pad + 1) < 2**31  # JAX keys blocks in int32
    host_ok = (nnz_a and nnz_b and products <= _SCAN3_MAX_PRODUCTS
               and keys_fit)
    if host_ok and T * P <= _GROUP_MAX_BLOCKS:
        return "group"
    if T * P <= MAX_UNROLL_BLOCKS and keys_fit and nnz_a > 0 and nnz_b > 0:
        return "unrolled"
    if host_ok and T <= _SCAN3_MAX_TILES:
        return "scan3"
    return "scan2"


def alg3_engine(a, b, chunk_fraction: float, host=None) -> str:
    """The engine `spgemm_alg3_blocked` picks for A and B at
    `chunk_fraction` (`select_alg3_engine`); `host` holds A's indptr and
    indices and B's indptr and indices on the host, read here where it is
    not given."""
    _, P, n_pad, _, T = _alg3_grid(a.shape[0], b.shape[1], chunk_fraction)
    if host is None:
        host = prim.to_host(a.indptr, a.indices, b.indptr, b.indices,
                            what="operands")
    products = (int(np.diff(host[2])[host[1]].sum())
                if a.nnz and b.nnz else 0)
    return select_alg3_engine(a.nnz, b.nnz, products, T, P, n_pad)


def spgemm_alg3_blocked(a, b, alpha, chunk_fraction: float,
                        precision: str = "highest", verbose: bool = False,
                        unroll: Optional[bool] = None,
                        engine: Optional[str] = None):
    """Chunked low-memory blocked SpGEMM; see the module docstring.
    `engine` forces one of "group", "unrolled", "scan3", "scan2"; the
    legacy `unroll` maps True to "unrolled" and False to the scan family.
    The four engines give bitwise-equal outputs."""
    m = a.shape[0]
    n = b.shape[1]
    alpha = prim.scalar_as(alpha, a.dtype)
    n_b, P, n_pad, m_pad, T = _alg3_grid(m, n, chunk_fraction)
    if engine is None:
        engine = {True: "unrolled", False: None}.get(unroll)
    if engine is not None and engine not in _ENGINES:
        raise ValueError(f"unknown alg3 engine {engine!r} (expected one of "
                         f"{_ENGINES})")
    host = prim.to_host(a.indptr, a.indices, b.indptr, b.indices,
                        what="operands")
    if engine is None:
        engine = alg3_engine(a, b, chunk_fraction, host)
    if engine == "scan2":
        return _spgemm_alg3_scan2(a, b, host, alpha, n_b, P, T, m_pad,
                                  n_pad, verbose, precision)
    run = {"group": _spgemm_alg3_group, "unrolled": _spgemm_alg3_unrolled,
           "scan3": _spgemm_alg3_scan3}[engine]
    return run(a, b, host, alpha, n_b, P, T, m_pad, verbose, precision)
