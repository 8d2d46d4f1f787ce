"""Sparse collectives: moving sparse matrices between ranks.

Port of `spmm_tpu/parallel/collectives.py`.  The reference's
`_SparseNCCLCommunicator` sends a size header, then the component arrays.
JAX keeps one wire format instead, which the port keeps too: a CSR moves as
(indptr, indices[cap], data[cap], nnz), padded to a capacity common to
every rank, so every rank makes the same calls with tensors of the same
shapes.  JAX's `ppermute` becomes a `batch_isend_irecv` of P2P ops, its
`all_to_all` `all_to_all_single`, its `all_gather`
`all_gather_into_tensor`; `broadcast` and `scatter` are their `dist` forms
(after a size header where only the root knows the sizes), `gather` the
all-gather and slice JAX makes of it.

Every function is SPMD: each rank of the mesh calls it with its own part,
where JAX takes the stacked (D, ...) global array (rank r's part is JAX's
row r) or the list of D matrices (rank r passes the r-th).  Float sums
across ranks are added in rank order (`_comm`), so they are the same bits
on every backend and every run.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.segment_sum import segment_sum_inorder
from spmm_tpu_torch.parallel import _comm
from spmm_tpu_torch.parallel.mesh import Mesh

INDEX_DTYPE = prim.INDEX_DTYPE

Wire = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pad_csr(a, capacity: int) -> Wire:
    """(indptr, indices[cap], data[cap], nnz) — the padded wire format."""
    if capacity < a.nnz:
        raise ValueError(f"capacity {capacity} < nnz {a.nnz}")
    pad = capacity - a.nnz
    indices = torch.cat([a.indices, a.indices.new_zeros(pad)])
    data = torch.cat([a.data, a.data.new_zeros(pad)])
    return (a.indptr, indices, data,
            torch.tensor(a.nnz, dtype=INDEX_DTYPE, device=a.data.device))


def unpad_csr(indptr, indices, data, nnz: int, shape):
    from spmm_tpu_torch.sparse.csr import CSR

    nnz = int(nnz)
    return CSR.from_parts(indptr, indices[:nnz], data[:nnz], shape,
                          canonical=True, device=data.device)


def all_gather_csr_blocks(a_sharded, mesh: Optional[Mesh] = None,
                          axis: Optional[str] = None) -> Wire:
    """Every shard's padded row block of a ShardedCSR, on every rank:
    (indptr (D, r+1), indices (D, E), data (D, E), nnz (D,)).  The
    capacity is already the largest shard's nnz, so no header goes first;
    nnz comes from the shards' host counts."""
    sh = a_sharded
    mesh, axis = sh.mesh, sh.axis
    return (_comm.gather(sh.indptr, mesh, axis),
            _comm.gather(sh.indices, mesh, axis),
            _comm.gather(sh.data, mesh, axis),
            torch.tensor(sh.nnz_per, dtype=INDEX_DTYPE, device=mesh.device))


def psum_dense(x, mesh: Mesh, axis: str) -> torch.Tensor:
    """Dense all-reduce over a mesh axis (`NCCLBackend.all_reduce`):
    every rank's `x` (JAX's row r of the stacked input) summed in rank
    order, on every rank."""
    return _comm.sum_across(torch.as_tensor(x, device=mesh.device), mesh,
                            axis)


def barrier(mesh: Mesh, axis: str) -> None:
    """Every rank of the axis blocks until all have reached the call
    (`NCCLBackend.barrier`): an integer all-reduce of one element, whose
    result the host waits for."""
    tok = torch.ones(1, dtype=torch.int32, device=mesh.device)
    dist.all_reduce(tok, group=mesh.group(axis))
    tok.item()


def reduce_scatter_dense(x, mesh: Mesh, axis: str) -> torch.Tensor:
    """Dense reduce-scatter (`NCCLBackend.reduce_scatter`): rank d gets
    rows [d·m/D, (d+1)·m/D) of the sum of every rank's `x` (m, ...),
    summed in rank order (`_comm.reduce_scatter`)."""
    D = mesh.shape[axis]
    x = torch.as_tensor(x, device=mesh.device)
    if x.shape[0] % D:
        raise ValueError(f"rows {x.shape[0]} not divisible by {D} shards")
    return _comm.reduce_scatter(x.reshape(D, -1, *x.shape[1:]), mesh, axis)


def _wire(a, cap: int) -> Wire:
    return pad_csr(a.sum_duplicates(), cap)


def _common_cap(a, mesh: Mesh, axis: str, cap) -> int:
    """`cap`, or the largest nnz of every rank's matrix (one gather)."""
    if cap is not None:
        return int(cap)
    return max(max(r[0] for r in _comm.gather_ints([a.nnz], mesh, axis)), 1)


def all_reduce_csr(a, mesh: Mesh, axis: str, cap=None):
    """The canonical sum of every rank's CSR `a` (one shape), on every
    rank (`_SparseNCCLCommunicator.all_reduce`, which the reference makes
    reduce-to-root + bcast).  Each rank's entries travel in the wire format
    (capacity: `cap`, or the largest nnz); every rank then takes the union
    in rank order, stable-sorts it by (row, column) and sums each run of
    equal positions in order from +0.0: JAX's reduction, bitwise, and the
    same on every rank."""
    m, n = a.shape
    cap = _common_cap(a, mesh, axis, cap)
    ip, ix, dv, nz = (_comm.gather(t, mesh, axis) for t in _wire(a, cap))
    nzs = nz.tolist()
    rows = torch.cat([prim.rows_from_indptr(ip[d], nzs[d])
                      for d in range(len(nzs))])
    cols = torch.cat([ix[d, :nzs[d]] for d in range(len(nzs))])
    vals = torch.cat([dv[d, :nzs[d]] for d in range(len(nzs))])
    row_s, col_s, (val_s,) = prim.lexsort_rowcol(rows, cols, (vals,),
                                                 (m, n))
    head = prim.new_group(row_s, col_s) if row_s.numel() else \
        torch.zeros(0, dtype=torch.bool, device=row_s.device)
    nnz_u = int(head.sum())
    first = prim.compact_positions(head, nnz_u)[:nnz_u].long()
    ends = torch.cat([first[1:], first.new_tensor([row_s.numel()])])[:nnz_u]
    summed = segment_sum_inorder(val_s, first, ends - first)
    indptr = prim.build_indptr(row_s[first], m)
    return unpad_csr(indptr, col_s[first], summed, nnz_u, (m, n))


def reduce_csr(a, mesh: Mesh, axis: str, root: int = 0, cap=None):
    """Sparse reduce-to-root (`_SparseNCCLCommunicator.reduce`): the
    all-reduce already leaves the sum on every rank, so the root is
    nominal, as in JAX: returns the summed CSR (what root holds)."""
    return all_reduce_csr(a, mesh, axis, cap)


def reduce_scatter_csr(a, mesh: Mesh, axis: str, cap=None):
    """Sparse reduce-scatter: rank d gets row block d of the summed CSR.
    The reference's sparse all_reduce recipe (reduce + redistribute), as
    JAX makes it: the replicated sparse sum, then this rank's rows of it
    (sparse row extents are runtime values, so the split is a local
    slice)."""
    D = mesh.shape[axis]
    s = all_reduce_csr(a, mesh, axis, cap)
    m = s.shape[0]
    if m % D:
        raise ValueError(f"rows {m} not divisible by {D} shards")
    r = m // D
    d = mesh.index(axis)
    return s[d * r:(d + 1) * r]


def ppermute_csr(parts: Wire, mesh: Mesh, axis: str, perm) -> Wire:
    """Move wire components round the axis (the send/recv ring of
    `_nccl_comm.send`/`recv`): each (src, dst) pair of coordinates sends
    src's `parts` to dst; a rank no pair sends to gets zeros, as JAX's
    ppermute gives."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    out, pending = _comm.permute(tuple(parts), mesh, axis, perm)
    _comm.wait(pending)
    return out


def send_recv_csr(parts: Wire, mesh: Mesh, axis: str, src: int,
                  dst: int) -> Wire:
    """Point-to-point transfer of one rank's wire components
    (`_SparseNCCLCommunicator.send`/`recv`): a one-pair ppermute; every
    other rank gets zeros, as only `dst` posts a receive."""
    return ppermute_csr(parts, mesh, axis, [(int(src), int(dst))])


def broadcast_csr(parts: Wire, mesh: Mesh, axis: str, root: int = 0) -> Wire:
    """Every rank gets the root's wire components (`_nccl_comm.broadcast`;
    every rank's parts have the root's shapes, as in JAX)."""
    out = tuple(p.clone() for p in parts)
    src = mesh.ranks(axis)[int(root)]
    for t in out:
        dist.broadcast(t, src, group=mesh.group(axis))
    return out


def all_to_all_csr(parts: Wire, mesh: Mesh, axis: str) -> Wire:
    """Transpose a block matrix of wire components across the axis: this
    rank's block j (parts[c][j], leading dim D) goes to rank j as its block
    i (`_nccl_comm.all_to_all`: the exchange of partial product rows in a
    distributed SpGEMM)."""
    return tuple(_comm.exchange(c, mesh, axis) for c in parts)


# the value dtypes the size header of `scatter_csr` can name
_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128,
           torch.bfloat16, torch.float16, torch.int32, torch.int64)


def scatter_csr(mats: Optional[Sequence], mesh: Mesh, axis: str,
                root: int = 0, cap=None) -> Wire:
    """The root scatters one CSR to each rank
    (`_SparseNCCLCommunicator.scatter`): on the root `mats` holds the D
    matrices (elsewhere it is not read).  The root pads them to a common
    capacity and broadcasts the size header (capacity, rows, value dtype),
    then each wire component goes out with `dist.scatter`.  Returns this
    rank's wire components (JAX's row r of the stacked wire)."""
    D = mesh.shape[axis]
    dev = mesh.device
    src = mesh.ranks(axis)[int(root)]
    wires = None
    header = torch.zeros(3, dtype=torch.int64, device=dev)
    if mesh.index(axis) == root:
        if len(mats) != D:
            raise ValueError(f"need one CSR per shard ({D}), got {len(mats)}")
        if cap is None:
            cap = max(max(a.nnz for a in mats), 1)
        wires = [_wire(a.to(dev), int(cap)) for a in mats]
        header = torch.tensor([int(cap), mats[0].shape[0],
                               _DTYPES.index(wires[0][2].dtype)],
                              dtype=torch.int64, device=dev)
    dist.broadcast(header, src, group=mesh.group(axis))
    cap, m, code = header.tolist()
    out = (torch.empty(m + 1, dtype=INDEX_DTYPE, device=dev),
           torch.empty(cap, dtype=INDEX_DTYPE, device=dev),
           torch.empty(cap, dtype=_DTYPES[code], device=dev),
           torch.empty((), dtype=INDEX_DTYPE, device=dev))
    for c, t in enumerate(out):
        pieces = None if wires is None else [w[c].contiguous()
                                             for w in wires]
        dist.scatter(t, pieces, src, group=mesh.group(axis))
    return out


def gather_csr(parts: Wire, mesh: Mesh, axis: str, root: int = 0,
               shape=None):
    """Every rank's wire CSR, as a list of CSRs in rank order
    (`_SparseNCCLCommunicator.gather`): an all_gather of the components,
    as JAX makes it (the root's copy is everyone's)."""
    if shape is None:
        raise ValueError("gather_csr needs the (m, n) block shape")
    gip, gix, gdv, gnz = (_comm.gather(c, mesh, axis) for c in parts)
    return [unpad_csr(gip[d], gix[d], gdv[d], int(gnz[d]), shape)
            for d in range(mesh.shape[axis])]
