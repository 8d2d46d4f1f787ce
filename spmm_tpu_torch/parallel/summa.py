"""2-D (SUMMA-style) distributed dense-intermediate SpGEMM.

Port of `spmm_tpu/parallel/summa.py`.  JAX densifies each operand shard
and lets GSPMD turn one sharded `jnp.dot` into the SUMMA loop.  Here the
loop is spelled out on a ("x", "y") mesh of ranks (rank = x * ny + y):
rank (x, y) multiplies A's row block x, restricted to k-block y, by B's
k-block y, then the partial products are reduced over the `y` subgroup,
each rank keeping its column block y.  C comes out laid out (x, y), as
JAX's `P("x", "y")`.  The reduction adds the ny partials in rank order
(`_comm.reduce_scatter`), so C has the same bits on every backend and run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels.extract_roll import extract_roll
from spmm_tpu_torch.ops.spgemm import _value_matmul
from spmm_tpu_torch.parallel import _comm
from spmm_tpu_torch.parallel.mesh import Mesh, make_mesh
from spmm_tpu_torch.parallel.sharded import ShardedCSR, _dense_rows

INDEX_DTYPE = prim.INDEX_DTYPE


def make_mesh_2d(nx: int, ny: int, *, device=None) -> Mesh:
    """An (nx, ny) mesh with axes ("x", "y") over every rank of the
    process group."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if nx * ny > world:
        raise ValueError(f"mesh {nx}x{ny} needs {nx * ny} devices, "
                         f"have {world}")
    return make_mesh(nx * ny, axes=("x", "y"), shape=(nx, ny), device=device)


def _equal_bounds(bounds) -> bool:
    sizes = [bounds[i + 1] - bounds[i] for i in range(len(bounds) - 1)]
    return len(set(sizes)) == 1


def _span(i: int, d: int, size: int) -> Tuple[int, int]:
    """Block i of `size` cut into d blocks of ceil(size/d)."""
    w = -(-size // d)
    return min(i * w, size), min((i + 1) * w, size)


def _b_kblock(b: ShardedCSR, mesh: Mesh, k0: int, k1: int) -> torch.Tensor:
    """B's rows [k0, k1) dense, on this rank.  Sharded on "y" they are this
    rank's own block; sharded on "x" the dense row blocks are gathered over
    the x subgroup first (B whole on each rank, as GSPMD's relayout)."""
    k, n = b.shape
    bd, _ = _dense_rows(b, n, False)
    if b.axis == "y":
        return bd
    full = _comm.gather(bd, mesh, b.axis).reshape(-1, n)[:k]
    return full[k0:k1]


def spgemm_summa(a: ShardedCSR, b: ShardedCSR, mesh: Mesh) -> torch.Tensor:
    """C_dense = A @ B on a 2-D mesh, A row-sharded on "x" and B on "y"
    (its row blocks are then the k-blocks) or on "x".  Returns this
    rank's block (x, y) of the dense product: A's row block x by column
    block y of ceil(n/ny) columns (gather it with `unshard_blocks`).  For
    a sparse result use `spgemm_summa_sparse`."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if not (_equal_bounds(a.row_bounds) and _equal_bounds(b.row_bounds)):
        raise ValueError("spgemm_summa requires equal row blocks per shard "
                         "(shard with balance='rows' and m, k divisible "
                         "by the mesh axis)")
    if a.axis != "x" or b.axis not in ("x", "y"):
        raise ValueError(f"spgemm_summa takes A sharded on 'x' and B on 'x' "
                         f"or 'y', got {a.axis!r} and {b.axis!r}")
    ny = mesh.shape["y"]
    y = mesh.index("y")
    k0, k1 = _span(y, ny, k)
    if b.axis == "y":
        k0, k1 = b.row_bounds[y], b.row_bounds[y + 1]
    ad, _ = _dense_rows(a, k, False)
    part = _value_matmul(ad[:, k0:k1], _b_kblock(b, mesh, k0, k1),
                         "highest")
    cb = -(-n // ny)
    chunks = part.new_zeros((ny, part.shape[0], cb))
    for j in range(ny):
        c0, c1 = _span(j, ny, n)
        chunks[j, :, :c1 - c0] = part[:, c0:c1]
    c0, c1 = _span(y, ny, n)
    return _comm.reduce_scatter(chunks, mesh, "y")[:, :c1 - c0]


def unshard_blocks(c_block: torch.Tensor, shape, mesh: Mesh
                   ) -> torch.Tensor:
    """The global (m, n) array of every rank's (x, y) block, on every
    rank (blocks of ceil(m/nx) rows and ceil(n/ny) columns)."""
    m, n = shape
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    rb, cb = -(-m // nx), -(-n // ny)
    pad = c_block.new_zeros((rb, cb))
    pad[:c_block.shape[0], :c_block.shape[1]] = c_block
    g = _comm.gather(pad, mesh, "x").reshape(nx, rb, cb)
    g = _comm.gather(g, mesh, "y")  # (ny, nx, rb, cb)
    out = g.permute(1, 2, 0, 3).reshape(nx * rb, ny * cb)
    return out[:m, :n].contiguous()


def summa_compress_blocks(c_block: torch.Tensor, mesh: Mesh, shape):
    """Sparse compression of this rank's block of a SUMMA product: its
    nonzeros in row-major order (`extract_roll`), to a capacity set by one
    gather of every rank's count (the distributed spMatGetSize).  Returns
    (rows (cap,), cols (cap,), vals (cap,), nnz) with global coordinates,
    zeros past nnz: JAX's [x, y] of its (Dx, Dy, cap) arrays.  Nothing is
    gathered."""
    m, n = shape
    rb = -(-m // mesh.shape["x"])
    cb = -(-n // mesh.shape["y"])
    c_block = c_block.contiguous()
    mask = c_block != 0
    counts = _comm.gather(_comm.gather(mask.sum().reshape(1), mesh, "x"),
                          mesh, "y").view(-1).tolist()  # [y][x], one read
    cap = max(max(counts), 1)
    nnz = counts[mesh.index("y") * mesh.shape["x"] + mesh.index("x")]
    indptr, cols, vals = extract_roll(c_block, mask, cap)
    rows = torch.zeros(cap, dtype=INDEX_DTYPE, device=c_block.device)
    rows[:nnz] = prim.rows_from_indptr(indptr, nnz) + mesh.index("x") * rb
    cols[:nnz] += mesh.index("y") * cb
    return rows, cols, vals, torch.tensor(nnz, dtype=INDEX_DTYPE,
                                          device=c_block.device)


def spgemm_summa_sparse(a: ShardedCSR, b: ShardedCSR, mesh: Mesh):
    """Sparse-in/sparse-out SUMMA: the dense block product, then each
    rank's block compressed on its device (see `summa_compress_blocks`);
    `summa_blocks_to_csr` assembles the CSR for verification."""
    return summa_compress_blocks(spgemm_summa(a, b, mesh), mesh,
                                 (a.shape[0], b.shape[1]))


def summa_blocks_to_csr(blocks, shape, mesh: Mesh):
    """The CSR of every rank's compressed block, on every rank (test and
    inspection path): the blocks gathered in (x, y) order, as JAX walks
    them, into a COO, then to CSR."""
    from spmm_tpu_torch.sparse.coo import COO

    rows_b, cols_b, vals_b, nnz_b = (
        _comm.gather(_comm.gather(t, mesh, "y"), mesh, "x") for t in blocks)
    nnz = nnz_b.reshape(-1).tolist()
    rows_b, cols_b, vals_b = (t.reshape(len(nnz), -1)
                              for t in (rows_b, cols_b, vals_b))
    rows = torch.cat([rows_b[i, :c] for i, c in enumerate(nnz)])
    cols = torch.cat([cols_b[i, :c] for i, c in enumerate(nnz)])
    vals = torch.cat([vals_b[i, :c] for i, c in enumerate(nnz)])
    return COO((vals, (rows, cols)), shape=shape).tocsr()
