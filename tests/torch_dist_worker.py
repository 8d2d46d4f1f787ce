"""Ranks for the distributed tests of the port: a pool of gloo processes.

`RankPool(world, tmpdir)` spawns `world` processes once; each joins one
process group through a `FileStore` in `tmpdir` (no TCP port to clash
between test workers), on the CPU, and builds a 1-D mesh of every rank and,
at world 4, the 2x2 ("x", "y") mesh.  `pool.run(name, **inputs)` sends
numpy inputs to every rank, where `CASES[name]` runs SPMD, and returns each
rank's outputs as numpy arrays, in rank order.

This module imports torch, numpy and spmm_tpu_torch only: a spawned child
imports the module of its target, so neither jax nor the tests' conftest
reaches the ranks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback

import numpy as np
import torch

import spmm_tpu_torch as pt
from spmm_tpu_torch import parallel as pp
from spmm_tpu_torch.parallel import collectives as pc
from spmm_tpu_torch.parallel import summa

# a collective that waits longer than this has lost a rank
TIMEOUT_S = 60.0


def host(x):
    """numpy of a tensor (or of each tensor in a tuple or list)."""
    if isinstance(x, (tuple, list)):
        return [host(t) for t in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def csr(arrays):
    """The port's CSR on the CPU from (indptr, indices, data, shape,
    canonical)."""
    ip, ix, dv, shape, canonical = arrays
    return pt.CSR.from_parts(ip, ix, dv, tuple(shape), canonical=canonical,
                             device="cpu")


def csr_host(a):
    return {"indptr": host(a.indptr), "indices": host(a.indices),
            "data": host(a.data), "shape": tuple(a.shape)}


def shard_host(s):
    return {"indptr": host(s.indptr), "indices": host(s.indices),
            "data": host(s.data), "nnz_per": s.nnz_per,
            "nnz_local": s.nnz_local, "row_bounds": s.row_bounds,
            "n_shards": s.n_shards, "nnz": s.nnz,
            "rows_per_shard": s.rows_per_shard}


# ---------------------------------------------------------------------------
# the cases, one per test of tests/test_distributed.py (and a few more)
# ---------------------------------------------------------------------------


def case_shard(mesh, mesh2, a, balance, layout=False):
    A = csr(a)
    target = pp.row_sharded(mesh) if layout else mesh
    sh = pp.shard_csr(A, target, balance=balance)
    eye = torch.eye(A.shape[1], dtype=A.data.dtype)
    y = pp.spmm_sharded(sh, eye, mesh)
    return {**shard_host(sh), "eye_local": host(y),
            "eye": host(pp.unshard_rows(y, A.shape[0], sh.row_bounds, mesh))}


def case_spmv(mesh, mesh2, a, x, balance):
    A = csr(a)
    sh = pp.shard_csr(A, mesh, balance=balance)
    y = pp.spmv_sharded(sh, torch.from_numpy(x), mesh)
    return {"local": host(y),
            "global": host(pp.unshard_rows(y, A.shape[0], sh.row_bounds,
                                           mesh))}


def case_stream(mesh, mesh2, a, x, balance, use_plan=True):
    A = csr(a)
    sh = pp.shard_csr(A, mesh, balance=balance)
    plan = pp.spmv_stream_plan(sh, mesh) if use_plan else sh
    xs = pp.shard_vector(torch.from_numpy(x), mesh)
    y = pp.spmv_sharded_streamed(plan, xs, mesh)
    y_again = pp.spmv_sharded_streamed(plan, xs, mesh)
    y2 = pp.spmv_sharded_blocked(plan, torch.from_numpy(x), mesh)
    out = {"xs": host(xs), "local": host(y), "again": host(y_again),
           "blocked": host(y2),
           "global": host(pp.unshard_rows(y, A.shape[0], sh.row_bounds,
                                          mesh))}
    if use_plan:
        out.update({"rows": host(plan.rows), "cols": host(plan.cols),
                    "data": host(plan.data), "nb": plan.nb, "Eb": plan.Eb})
    return out


def case_spmv_t(mesh, mesh2, a, y):
    A = csr(a)
    sh = pp.shard_csr(A, mesh)
    i = mesh.index("rows")
    r0, r1 = sh.row_bounds[i], sh.row_bounds[i + 1]
    y_blk = np.zeros(sh.rows_per_shard, np.float32)
    y_blk[:r1 - r0] = y[r0:r1]
    return {"x": host(pp.spmv_t_sharded(sh, torch.from_numpy(y_blk), mesh))}


def case_spmm(mesh, mesh2, a, b, balance):
    A = csr(a)
    sh = pp.shard_csr(A, mesh, balance=balance)
    c = pp.spmm_sharded(sh, torch.from_numpy(b), mesh)
    return {"local": host(c),
            "global": host(pp.unshard_rows(c, A.shape[0], sh.row_bounds,
                                           mesh))}


def case_spgemm_dense(mesh, mesh2, a, b):
    A = csr(a)
    sh = pp.shard_csr(A, mesh)
    c = pp.spgemm_dense_sharded(sh, torch.from_numpy(b), mesh)
    return {"local": host(c),
            "global": host(pp.unshard_rows(c, A.shape[0], sh.row_bounds,
                                           mesh))}


def case_all_gather_csr(mesh, mesh2, a):
    sh = pp.shard_csr(csr(a), mesh)
    return host(pc.all_gather_csr_blocks(sh, mesh))


def case_psum(mesh, mesh2, x):
    r = mesh.index("rows")
    return {"sum": host(pc.psum_dense(torch.from_numpy(x[r]), mesh, "rows"))}


def case_barrier(mesh, mesh2):
    return {"first": pc.barrier(mesh, "rows"),
            "second": pc.barrier(mesh, "rows")}


def case_summa(mesh, mesh2, a, b, b_axis, sparse=False):
    A, B = csr(a), csr(b)
    ash = pp.shard_csr(A, mesh2, axis="x")
    bsh = pp.shard_csr(B, mesh2, axis=b_axis)
    shape = (A.shape[0], B.shape[1])
    if sparse:
        blocks = summa.spgemm_summa_sparse(ash, bsh, mesh2)
        return {"blocks": host(blocks),
                "csr": csr_host(summa.summa_blocks_to_csr(blocks, shape,
                                                          mesh2))}
    c = pp.spgemm_summa(ash, bsh, mesh2)
    return {"local": host(c),
            "global": host(summa.unshard_blocks(c, shape, mesh2)),
            "coords": (mesh2.index("x"), mesh2.index("y"))}


def case_all_reduce(mesh, mesh2, mats):
    r = mesh.index("rows")
    return csr_host(pc.all_reduce_csr(csr(mats[r]), mesh, "rows"))


def case_reduce_scatter_csr(mesh, mesh2, mats):
    r = mesh.index("rows")
    return csr_host(pc.reduce_scatter_csr(csr(mats[r]), mesh, "rows"))


def _wire_of(mats, r):
    cap = max(int(m[0][-1]) for m in mats)
    return pc.pad_csr(csr(mats[r]), cap)


def case_ppermute_bcast(mesh, mesh2, mats):
    D = mesh.shape["rows"]
    parts = _wire_of(mats, mesh.index("rows"))
    perm = [(i, (i + 1) % D) for i in range(D)]
    return {"ring": host(pc.ppermute_csr(parts, mesh, "rows", perm)),
            "bcast": host(pc.broadcast_csr(parts, mesh, "rows",
                                           root=D - 1))}


def case_all_to_all(mesh, mesh2, mats):
    """mats[i][j]: rank i's block j."""
    r = mesh.index("rows")
    cap = max(int(m[0][-1]) for row in mats for m in row)
    wires = [pc.pad_csr(csr(m), cap) for m in mats[r]]
    parts = tuple(torch.stack([w[c] for w in wires]) for c in range(4))
    return host(pc.all_to_all_csr(parts, mesh, "rows"))


def case_scatter_gather(mesh, mesh2, mats, shape):
    D = mesh.shape["rows"]
    root_mats = ([csr(m) for m in mats] if mesh.index("rows") == 0
                 else None)
    parts = pc.scatter_csr(root_mats, mesh, "rows")
    sent = pc.send_recv_csr(parts, mesh, "rows", 0, D - 1)
    back = pc.gather_csr(parts, mesh, "rows", shape=tuple(shape))
    return {"scatter": host(parts), "send_recv": host(sent),
            "gather": [csr_host(c) for c in back]}


def case_reduce_scatter_dense(mesh, mesh2, x):
    r = mesh.index("rows")
    return {"out": host(pc.reduce_scatter_dense(torch.from_numpy(x[r]),
                                                mesh, "rows"))}


def case_spgemm_sparse(mesh, mesh2, a, b, stream_b, balance_b="rows",
                       precision="highest", rerun=False):
    A, B = csr(a), csr(b)
    ash = pp.shard_csr(A, mesh)
    bsh = pp.shard_csr(B, mesh, balance=balance_b)
    c = pp.spgemm_sharded_sparse(ash, bsh, mesh, stream_b=stream_b,
                                 precision=precision)
    out = {**shard_host(c), "csr": csr_host(pp.sharded_to_csr(c))}
    if rerun:
        again = pp.spgemm_sharded_sparse(ash, bsh, mesh, stream_b=stream_b,
                                         precision=precision)
        out["again"] = host(again.data)
    return out


def case_mesh_errors(mesh, mesh2):
    """The ValueErrors of `make_mesh` and `make_mesh_2d`, worded as JAX's
    where JAX has them."""
    world = mesh.size
    said = {}
    for name, call in (
            ("count", lambda: pp.make_mesh(world + 1, device="cpu")),
            ("shape", lambda: pp.make_mesh(world, axes=("x", "y"),
                                           device="cpu")),
            ("product", lambda: pp.make_mesh(world, axes=("x", "y"),
                                             shape=(world, 2),
                                             device="cpu")),
            ("mesh_2d", lambda: summa.make_mesh_2d(world, 2, device="cpu")),
            ("replicated", lambda: pp.shard_csr(
                csr((np.zeros(2, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.float32), (1, 1), True)),
                pp.replicated(mesh)))):
        try:
            call()
            said[name] = None
        except ValueError as e:
            said[name] = str(e)
    return said


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def serve(rank, world, store_path, conn):
    """A rank's loop: join the group, build the meshes, run each case sent
    until None comes."""
    torch.set_num_threads(1)
    try:
        pp.init_process_group(store_path=store_path, world_size=world,
                              rank=rank, device="cpu", timeout_s=TIMEOUT_S)
        mesh = pp.make_mesh(world, device="cpu")
        mesh2 = summa.make_mesh_2d(2, world // 2) if world % 2 == 0 \
            else None
        conn.send(("ok", None))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, inputs = msg
        try:
            conn.send(("ok", CASES[name](mesh, mesh2, **inputs)))
        except Exception:
            conn.send(("error", traceback.format_exc()))
    pp.destroy_process_group()


class RankPool:
    """`world` gloo ranks on the CPU, started once (see the module
    docstring)."""

    def __init__(self, world: int, tmpdir):
        ctx = mp.get_context("spawn")
        self.world = world
        store = os.path.join(str(tmpdir), "store")
        self.conns, self.procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=serve, args=(r, world, store, child),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)
        self._collect("start-up")

    def _collect(self, what):
        outs, errors = [], []
        for r, c in enumerate(self.conns):
            if not c.poll(2 * TIMEOUT_S):
                self.close()
                raise AssertionError(f"rank {r} gave no answer to {what}")
            status, out = c.recv()
            if status != "ok":
                errors.append(f"rank {r}:\n{out}")
            outs.append(out)
        if errors:
            raise AssertionError(f"{what} failed on rank(s):\n"
                                 + "\n".join(errors))
        return outs

    def run(self, name: str, **inputs):
        """Every rank's outputs of CASES[name](mesh, mesh2, **inputs)."""
        for c in self.conns:
            c.send((name, inputs))
        return self._collect(name)

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
