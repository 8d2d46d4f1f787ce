"""Row-partitioned sparse matrices over the ranks of a mesh.

Port of `spmm_tpu/parallel/sharded.py`.  JAX stacks every shard on a
leading device axis of one global array; here each rank holds only its own
shard, as local tensors on its device (JAX's row r is rank r's tensor), and
every op is called by every rank of the mesh with its own shard.  The
layout is JAX's, bit for bit:
  * rows split into contiguous blocks (balanced by rows or by nnz);
  * each shard a local CSR (indptr over its rows, indices, data) padded to
    the largest shard's nnz E with data 0, so padding is inert;
  * `row_bounds` and every shard's nnz are host metadata (the "size
    header"), known to every rank.

The work on a shard runs through the port's hand-written kernels where one
computes it: the in-order `segment_sum` for SpMV (JAX's `segment_sum` bit
for bit), `spmm_routed` for SpMM, `densify_onehot` for every CSR -> dense
step, `extract_roll` for every dense -> CSR compaction; the GEMMs are
library calls in IEEE float32 for "highest".  Float sums across ranks are
gathered and added in rank order (`_comm`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.densify_onehot import densify_onehot
from spmm_tpu_torch.ops.kernels.extract_roll import extract_roll
from spmm_tpu_torch.ops.kernels.segment_sum import segment_sum_inorder
from spmm_tpu_torch.ops.kernels.spmv_routed import (spmm_routed,
                                                    spmv_routed_plan)
from spmm_tpu_torch.ops.spgemm import _check_precision, _value_matmul
from spmm_tpu_torch.parallel import _comm
from spmm_tpu_torch.parallel.mesh import Mesh, resolve_layout

INDEX_DTYPE = prim.INDEX_DTYPE


class ShardedCSR:
    """This rank's row shard of a CSR, padded to the common shape.

    indptr: (rows_per_shard + 1,) local row pointers
    indices: (E,) int32, data: (E,), padded to E = max shard nnz
    nnz_per: every shard's valid-entry count, in shard order (host ints)
    """

    def __init__(self, indptr, indices, data, nnz_per, shape, row_bounds,
                 mesh: Mesh, axis: str):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self.nnz_per = tuple(int(v) for v in nnz_per)
        self._shape = (int(shape[0]), int(shape[1]))
        self.row_bounds = tuple(int(b) for b in row_bounds)
        self.mesh = mesh
        self.axis = axis
        self._plan = None  # spmm_routed's plan, built on first use
        self._by_column = None  # the transpose's order, built on first use

    @property
    def shape(self):
        return self._shape

    @property
    def n_shards(self) -> int:
        return len(self.row_bounds) - 1

    @property
    def rows_per_shard(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return sum(self.nnz_per)

    @property
    def index(self) -> int:
        """This rank's shard number."""
        return self.mesh.index(self.axis)

    @property
    def nnz_local(self) -> int:
        return self.nnz_per[self.index]

    def valid(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(indptr, indices, data) of the shard without its padding: a
        canonical CSR of (rows_per_shard, n)."""
        nz = self.nnz_local
        return self.indptr, self.indices[:nz], self.data[:nz]

    def segments(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(starts, lengths) of the local rows, for `segment_sum_inorder`."""
        return self.indptr[:-1], self.indptr[1:] - self.indptr[:-1]

    def by_column(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(rows, order, t_indptr) of the shard, made once: each entry's
        row, the entries in column order (a stable sort, so rows ascend
        within a column) and the transpose's indptr (n + 1,)."""
        if self._by_column is None:
            ip, ix, dv = self.valid()
            rows = prim.rows_from_indptr(ip, dv.numel())
            order = torch.arange(dv.numel(), dtype=INDEX_DTYPE,
                                 device=dv.device)
            t_indptr, rows_t, order_t = prim.csr_transpose(
                ip, ix, order, (self.rows_per_shard, self._shape[1]))
            self._by_column = (rows_t.long(), order_t.long(), t_indptr)
        return self._by_column

    def routed_plan(self):
        """`spmm_routed`'s plan of the shard (SpMM only), made once."""
        if self._plan is None:
            self._plan = spmv_routed_plan(*self.valid(), self.rows_per_shard,
                                          self._shape[1], sell=False)
        return self._plan


def _bounds(indptr_h: np.ndarray, m: int, D: int, balance: str):
    """JAX's row bounds of D shards (`shard_csr`)."""
    if balance == "nnz":
        total = int(indptr_h[-1])
        targets = [(total * (i + 1)) // D for i in range(D - 1)]
        cuts = [0] + [int(np.searchsorted(indptr_h, t, side="left"))
                      for t in targets] + [m]
        cuts = sorted(set(cuts))
        while len(cuts) < D + 1:
            cuts.append(m)
        return cuts[:D] + [m]
    if balance != "rows":
        raise ValueError(f"balance must be 'rows' or 'nnz', got {balance!r}")
    per = -(-m // D)
    return [min(i * per, m) for i in range(D)] + [m]


def shard_csr(a, mesh, axis: str = "rows",
              balance: str = "rows") -> ShardedCSR:
    """This rank's shard of `a` (every rank passes the same matrix) over
    `mesh[axis]`: equal row counts (balance="rows") or contiguous blocks
    balanced by nnz ("nnz"; better for skewed matrices, cf.
    models.power_law_rows).  Rows are padded up to rows_per_shard with
    empty rows.  `mesh` may be a `row_sharded` layout.  The shard lies on
    the mesh's device; its arrays, bounds and padding are JAX's row of the
    same matrix, bitwise."""
    mesh, axis = resolve_layout(mesh, axis)
    a = a.tocsr().sum_duplicates()
    m, n = a.shape
    D = mesh.shape[axis]
    indptr_h = a.indptr.cpu().numpy()
    bounds = _bounds(indptr_h, m, D, balance)
    rows_per_shard = max(bounds[i + 1] - bounds[i] for i in range(D))
    nnz_per = [int(indptr_h[bounds[i + 1]] - indptr_h[bounds[i]])
               for i in range(D)]
    E = max(max(nnz_per), 1)
    i = mesh.index(axis)
    r0, r1 = bounds[i], bounds[i + 1]
    e0, e1 = int(indptr_h[r0]), int(indptr_h[r1])
    local = indptr_h[r0:r1 + 1] - indptr_h[r0]
    indptr_s = np.full(rows_per_shard + 1, local[-1], np.int32)
    indptr_s[:r1 - r0 + 1] = local
    dev = mesh.device
    indices_s = torch.zeros(E, dtype=INDEX_DTYPE, device=dev)
    data_s = torch.zeros(E, dtype=a.data.dtype, device=dev)
    indices_s[:e1 - e0] = a.indices[e0:e1]
    data_s[:e1 - e0] = a.data[e0:e1]
    return ShardedCSR(torch.from_numpy(indptr_s).to(dev), indices_s, data_s,
                      nnz_per, (m, n), bounds, mesh, axis)


def unshard_rows(y: torch.Tensor, shape_m: int, row_bounds: Sequence[int],
                 mesh: Mesh, axis: str = "rows") -> torch.Tensor:
    """The global array of every rank's row block `y` (rows_per_shard,
    ...), on every rank: an all_gather, then each shard's rows without
    its trailing padding, in shard order.  `shape_m` is the global row
    count, as in JAX."""
    g = _comm.gather(y, mesh, axis)
    parts = [g[i, :row_bounds[i + 1] - row_bounds[i]]
             for i in range(len(row_bounds) - 1)]
    out = torch.cat(parts, 0)
    if out.shape[0] != shape_m:
        raise ValueError(f"unshard_rows: bounds give {out.shape[0]} rows, "
                         f"not {shape_m}")
    return out


# ---------------------------------------------------------------------------
# dense-operand ops
# ---------------------------------------------------------------------------


def _on(x, sh: ShardedCSR, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=sh.mesh.device, dtype=dtype)


def _local_spmv(sh: ShardedCSR, x: torch.Tensor) -> torch.Tensor:
    """Local CSR·x: products in CSR order, each row summed in order from
    +0.0 by the `segment_sum` kernel (JAX's `segment_sum` of sorted ids);
    padding entries lie past the last row and are never read."""
    prod = sh.data * x[sh.indices.long()]
    return segment_sum_inorder(prod, *sh.segments())


def spmv_sharded(a: ShardedCSR, x, mesh: Optional[Mesh] = None,
                 axis: str = "rows") -> torch.Tensor:
    """y = A @ x with A row-sharded, x replicated (the whole vector on
    every rank); returns this rank's rows of y, (rows_per_shard,).  `mesh`
    and `axis` are JAX's arguments; the shard carries its own."""
    return _local_spmv(a, _on(x, a))


def spmm_sharded(a: ShardedCSR, b, mesh: Optional[Mesh] = None,
                 axis: str = "rows") -> torch.Tensor:
    """C = A @ B with A row-sharded, B (dense) replicated; returns this
    rank's rows of C.  float32 goes through `spmm_routed` over the shard's
    plan (made once); other dtypes gather B's rows and sum each row in
    order (`segment_sum`)."""
    b = _on(b, a)
    if a.dtype == b.dtype == torch.float32:
        return spmm_routed(b.contiguous(), a.routed_plan())
    gathered = b[a.indices.long()] * a.data[:, None]
    return segment_sum_inorder(gathered, *a.segments())


def spmv_t_sharded(a: ShardedCSR, y, mesh: Optional[Mesh] = None,
                   axis: str = "rows") -> torch.Tensor:
    """x = A.T @ y with A and y row-sharded (y: this rank's rows): each
    shard sums its products per column, in row order (the entries in the
    column order of a stable sort, made once per shard, then the in-order
    `segment_sum`; no float atomics), then the partials are summed across
    ranks in rank order.  Every rank gets the whole x."""
    y = _on(y, a)
    rows, order, t_indptr = a.by_column()
    contrib = a.data[order] * y[rows]
    partial = segment_sum_inorder(contrib, t_indptr[:-1],
                                  t_indptr[1:] - t_indptr[:-1])
    return _comm.sum_across(partial, a.mesh, a.axis)


def _dense_rows(sh: ShardedCSR, cols: int, pattern: bool):
    """(values, bf16 pattern or None) of the shard as a dense
    (rows_per_shard, cols) array (`densify_onehot`)."""
    return densify_onehot(*sh.valid(), sh.rows_per_shard, cols,
                          with_pattern=pattern)


def spgemm_dense_sharded(a: ShardedCSR, b_dense, mesh: Optional[Mesh] = None,
                         axis: str = "rows") -> torch.Tensor:
    """Row-sharded SpGEMM via the ALG1 dense intermediate: each rank
    densifies its row block and multiplies the replicated dense B (IEEE
    float32).  Returns this rank's rows of the dense product (gather them
    with `unshard_rows`)."""
    ad, _ = _dense_rows(a, a.shape[1], False)
    return _value_matmul(ad, _on(b_dense, a, ad.dtype), "highest")


# ---------------------------------------------------------------------------
# the x-streaming SpMV
# ---------------------------------------------------------------------------


class SpmvStreamPlan(NamedTuple):
    """This rank's layout for the x-streaming ring SpMV: its entries
    grouped by x column block, padded per block to Eb.

    rows/cols/data: (D*Eb,); block j lives at [j*Eb, (j+1)*Eb), cols are
    block-local (ix - j*nb), padding rows point at the drop segment
    r_local (JAX's row of the same plan, bitwise).  Rows ascend within a
    block, so each row's run in a block is found by a search at call time
    (O(m/D) a rank, like the accumulators)."""
    rows: torch.Tensor
    cols: torch.Tensor
    data: torch.Tensor
    nb: int
    Eb: int
    r_local: int
    n: int
    mesh: Mesh
    axis: str


def shard_vector(x, mesh, axis: str = "rows") -> torch.Tensor:
    """This rank's block of a dense vector split into D column blocks of
    nb = ceil(n/D) (zero-padded to D*nb): the operand layout of
    `spmv_sharded_streamed`, O(n/D) a rank.  `mesh` may be a
    `row_sharded` layout."""
    mesh, axis = resolve_layout(mesh, axis)
    D = mesh.shape[axis]
    x = torch.as_tensor(x, device=mesh.device)
    n = int(x.shape[0])
    nb = -(-n // D)
    i = mesh.index(axis)
    out = torch.zeros(nb, dtype=x.dtype, device=mesh.device)
    part = x[i * nb:min((i + 1) * nb, n)]
    out[:part.numel()] = part
    return out


def spmv_stream_plan(a: ShardedCSR, mesh: Optional[Mesh] = None,
                     axis: str = "rows") -> SpmvStreamPlan:
    """Group this shard's entries by x column block (on the host, once per
    structure: the analysis phase of the streaming SpMV).  Within a block
    entries keep their CSR order, so each (row, block) partial is a fixed
    chain whatever the order the blocks arrive in.  Eb, the largest
    (shard, block) count, takes one gather of every rank's counts."""
    mesh, axis = a.mesh, a.axis
    D = mesh.shape[axis]
    n = a.shape[1]
    nb = -(-n // D)
    r_local = a.rows_per_shard
    nz = a.nnz_local
    ip_h = a.indptr.cpu().numpy()
    ix_h = a.indices[:nz].cpu().numpy()
    blk = ix_h // nb
    counts = np.bincount(blk, minlength=D)
    Eb = max(1, max(max(r) for r in _comm.gather_ints(counts, mesh, axis)))
    rows_s = np.full(D * Eb, r_local, np.int32)  # drop segment
    cols_s = np.zeros(D * Eb, np.int32)
    rows_i = np.repeat(np.arange(r_local, dtype=np.int32),
                       np.diff(ip_h))[:nz]
    order = np.argsort(blk, kind="stable")  # keeps CSR order in-block
    off = np.zeros(D + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    pos = np.arange(nz) - off[blk[order]] + blk[order] * Eb
    rows_s[pos] = rows_i[order]
    cols_s[pos] = ix_h[order] - blk[order] * nb
    data_s = torch.zeros(D * Eb, dtype=a.dtype)
    data_s[torch.from_numpy(pos)] = a.data[:nz].cpu()[torch.from_numpy(
        order)]
    dev = mesh.device
    return SpmvStreamPlan(torch.from_numpy(rows_s).to(dev),
                          torch.from_numpy(cols_s).to(dev), data_s.to(dev),
                          nb, Eb, r_local, n, mesh, axis)


def _plan_of(a_or_plan) -> SpmvStreamPlan:
    return (a_or_plan if isinstance(a_or_plan, SpmvStreamPlan)
            else spmv_stream_plan(a_or_plan))


def _block_partial(plan: SpmvStreamPlan, j: int,
                   x_blk: torch.Tensor) -> torch.Tensor:
    """One (rank, block) partial: products with the x block, each row's
    run (rows ascend within the block) summed in order from +0.0 by the
    `segment_sum` kernel, as JAX's scatter-add of the block adds."""
    sl = slice(j * plan.Eb, (j + 1) * plan.Eb)
    rows = plan.rows[sl]
    bounds = torch.searchsorted(rows, torch.arange(
        plan.r_local + 1, dtype=rows.dtype, device=rows.device))
    prod = plan.data[sl] * x_blk[plan.cols[sl].long()]
    return segment_sum_inorder(prod, bounds[:-1], bounds[1:] - bounds[:-1])


def _fold(plan: SpmvStreamPlan, dtype, blocks) -> torch.Tensor:
    """JAX's two-accumulator split right-fold: blocks my..0 into acc_low,
    then D-1..my+1 into acc_high, y = acc_low + acc_high.  `blocks` yields
    the x block of each step, block (my - s) mod D at step s."""
    D = plan.mesh.shape[plan.axis]
    my = plan.mesh.index(plan.axis)
    acc_low = torch.zeros(plan.r_local, dtype=dtype, device=plan.mesh.device)
    acc_high = torch.zeros_like(acc_low)
    for s, x_blk in enumerate(blocks):
        blk = (my - s) % D
        part = _block_partial(plan, blk, x_blk)
        if blk <= my:
            acc_low = part + acc_low
        else:
            acc_high = part + acc_high
    return acc_low + acc_high


def spmv_sharded_streamed(a_or_plan, x_block, mesh: Optional[Mesh] = None,
                          axis: str = "rows") -> torch.Tensor:
    """y = A @ x with A row-sharded AND x column-sharded (`shard_vector`):
    a rank holds O(n/D) of x.  The x blocks go round a P2P ring to
    coordinate + 1 (`_comm.ring`: each hop overlaps the product with the
    block in hand).  The fold is `spmv_sharded_blocked`'s, so the two are
    bitwise equal, and so is every rerun.  Returns this rank's rows."""
    plan = _plan_of(a_or_plan)
    xb = torch.as_tensor(x_block, device=plan.mesh.device)
    dtype = torch.promote_types(plan.data.dtype, xb.dtype)
    blocks = (t[0] for t in _comm.ring((xb,), plan.mesh, plan.axis))
    return _fold(plan, dtype, blocks)


def spmv_sharded_blocked(a_or_plan, x, mesh: Optional[Mesh] = None,
                         axis: str = "rows") -> torch.Tensor:
    """Replicated-x twin of `spmv_sharded_streamed`: the same per-block
    partials through the same fold, x sliced locally instead of sent round
    the ring: the bitwise cross-check of the streamed path (and the path
    where x is already whole on every rank)."""
    plan = _plan_of(a_or_plan)
    x = torch.as_tensor(x, device=plan.mesh.device)
    D = plan.mesh.shape[plan.axis]
    my = plan.mesh.index(plan.axis)
    xp = torch.zeros(D * plan.nb, dtype=x.dtype, device=x.device)
    xp[:x.shape[0]] = x
    dtype = torch.promote_types(plan.data.dtype, x.dtype)
    nb = plan.nb
    blocks = (xp[blk * nb:(blk + 1) * nb]
              for blk in ((my - s) % D for s in range(D)))
    return _fold(plan, dtype, blocks)


# ---------------------------------------------------------------------------
# sparse-in / sparse-out distributed SpGEMM
# ---------------------------------------------------------------------------


def _check_pair(a: ShardedCSR, b: ShardedCSR) -> Tuple[int, int, int]:
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    return m, k, n


def _pattern_of(values: torch.Tensor) -> torch.Tensor:
    """B's 0/1 pattern as JAX takes it for the count GEMM: its nonzero
    values (a stored zero of B counts as none)."""
    return (values != 0).to(torch.bfloat16)


def _count(ap: torch.Tensor, bp: torch.Tensor) -> torch.Tensor:
    """The count GEMM of bf16 0/1 patterns: every partial sum is a
    positive count or 0, so `> 0` is exact."""
    return torch.matmul(ap, bp).float()


def spgemm_sharded_sparse(a: ShardedCSR, b: ShardedCSR,
                          mesh: Optional[Mesh] = None, axis: str = "rows",
                          precision: str = "highest",
                          stream_b: bool = True) -> ShardedCSR:
    """C = A @ B, sparse in, sparse out, C row-sharded like A.

    With `stream_b=True` (the default) B stays row-sharded and its blocks
    go round a P2P ring: each rank densifies one (k/D, n) block a step and
    adds its product to its C panel, so its peak is O(k·n/D + m·k/D +
    m·n/D) rather than the O(k·n) of a whole dense B.  `stream_b=False`
    all-gathers B's blocks and densifies B whole on every rank.  Both give
    the same structure (the counts are exact); the streamed values add the
    K-block products in ring order, so they may differ from the replicated
    ones by float32 rounding.  Each rank compacts its panel to a capacity
    set by one gather of every rank's count (the distributed
    spMatGetSize) with `extract_roll`; C is never gathered."""
    _check_precision(precision)
    if stream_b:
        ct, counts = _panel_streamed(a, b, precision)
    else:
        ct, counts = _panel_replicated(a, b, precision)
    mask = counts > 0
    nnz_per = _comm.gather(mask.sum().reshape(1), a.mesh,
                           a.axis).view(-1).tolist()
    cap = max(max(nnz_per), 1)
    indptr, cols, vals = extract_roll(ct, mask, cap)
    return ShardedCSR(indptr, cols, vals, nnz_per, (a.shape[0],
                                                    b.shape[1]),
                      a.row_bounds, a.mesh, a.axis)


def _panel_replicated(a: ShardedCSR, b: ShardedCSR, precision: str):
    from spmm_tpu_torch.parallel.collectives import all_gather_csr_blocks

    m, k, n = _check_pair(a, b)
    ip_g, ix_g, dv_g, _ = all_gather_csr_blocks(b, b.mesh, b.axis)
    bd, _ = densify_onehot(*_blocks_to_csr(ip_g, ix_g, dv_g, b.nnz_per,
                                           b.row_bounds), k, n,
                           with_pattern=False)
    ad, apat = _dense_rows(a, k, True)
    return (_value_matmul(ad, bd, precision),
            _count(apat, _pattern_of(bd)))


def _panel_streamed(a: ShardedCSR, b: ShardedCSR, precision: str):
    """The B ring: after s hops along (i -> i+1) this rank holds block
    (my - s) mod D, and multiplies A's columns [r0, r1) by the block's r1
    - r0 real rows (JAX densifies A with k + rb columns so that its
    dynamic slice never clips; a static slice needs no head-room)."""
    m, k, n = _check_pair(a, b)
    mesh, axis = b.mesh, b.axis
    D = mesh.shape[axis]
    my = mesh.index(axis)
    rb = b.rows_per_shard
    ad, apat = _dense_rows(a, k, True)
    ct = torch.zeros((a.rows_per_shard, n), dtype=a.dtype, device=ad.device)
    counts = torch.zeros((a.rows_per_shard, n), dtype=torch.float32,
                         device=ad.device)
    for s, (ipb, ixb, dvb) in enumerate(
            _comm.ring((b.indptr, b.indices, b.data), mesh, axis)):
        blk = (my - s) % D
        nzb = b.nnz_per[blk]
        bd, _ = densify_onehot(ipb, ixb[:nzb], dvb[:nzb], rb, n,
                               with_pattern=False)
        r0, r1 = b.row_bounds[blk], b.row_bounds[blk + 1]
        bd = bd[:r1 - r0]
        counts += _count(apat[:, r0:r1], _pattern_of(bd))
        ct += _value_matmul(ad[:, r0:r1], bd, precision)
    return ct, counts


def _blocks_to_csr(ip, ix, dv, nnz_per, row_bounds):
    """(indptr, indices, data) of the whole matrix from every shard's
    padded arrays (D, ...), on their device: each shard's rows without
    trailing padding, its entries without padding, indptr offset by the
    entries before it."""
    indptr = [torch.zeros(1, dtype=INDEX_DTYPE, device=ip.device)]
    cols, vals = [], []
    base = 0
    for i, nz in enumerate(nnz_per):
        r = row_bounds[i + 1] - row_bounds[i]
        indptr.append(ip[i, 1:r + 1] + base)
        cols.append(ix[i, :nz])
        vals.append(dv[i, :nz])
        base += nz
    return torch.cat(indptr), torch.cat(cols), torch.cat(vals)


def sharded_to_csr(c: ShardedCSR):
    """The whole CSR of a ShardedCSR, on every rank (the `gather` of the
    sparse communicator; a test and inspection path)."""
    from spmm_tpu_torch.parallel.collectives import all_gather_csr_blocks
    from spmm_tpu_torch.sparse.csr import CSR

    ip, ix, dv, _ = all_gather_csr_blocks(c, c.mesh, c.axis)
    return CSR.from_parts(*_blocks_to_csr(ip, ix, dv, c.nnz_per,
                                          c.row_bounds),
                          c.shape, canonical=True, device=c.mesh.device)
