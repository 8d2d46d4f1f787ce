"""The port's distribution layer (`spmm_tpu_torch.parallel`) against the
JAX package's, at 4 ranks.

Each test is the twin of one in tests/test_distributed.py: JAX runs its
function on `make_mesh(4)` (or the 2x2 mesh for SUMMA) of the conftest's
CPU devices, and the same numpy inputs go to 4 gloo ranks of the port
(`torch_dist_worker.RankPool`, started once for the module).  Rank r's
local output is held against row r of JAX's global array, and the
gathered output against the whole.  Tolerances: bitwise for the layout,
every CSR collective's structure and moved values, sparse SpGEMM's
structure and the in-order sums (`spmv_sharded`, the streamed SpMV,
`all_reduce_csr`); rtol 1e-6 with atol 1e-6 max|ref| for float sums across
ranks and the GEMM products.  The memory-model test has no twin: the port
does not carry `utils/memory_model.py` (its card test reads the peak with
`max_memory_allocated`).
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import NamedSharding, PartitionSpec as P

import spmm_tpu as st
from spmm_tpu import parallel as jpp
from spmm_tpu.parallel import collectives as jpc
from spmm_tpu.parallel import sharded as jsharded
from spmm_tpu.parallel import summa as jsumma

from torch_port_helpers import as_bits
from torch_dist_worker import RankPool

D = 4
RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(D, tmp_path_factory.mktemp("ranks"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def mesh():
    return jpp.make_mesh(D)


@pytest.fixture(scope="module")
def mesh2():
    return jsumma.make_mesh_2d(2, 2)


def arrays(A):
    """What the ranks rebuild a JAX CSR from."""
    return (np.asarray(A.indptr), np.asarray(A.indices), np.asarray(A.data),
            tuple(A.shape), bool(A.has_canonical_format))


def case(m=97, n=83, d=0.1, seed=0):
    return st.random(m, n, density=d, format="csr", random_state=seed)


def bitwise(got, want):
    g, w = as_bits(np.asarray(got)), as_bits(np.asarray(want))
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def close(got, want, rtol=RTOL):
    w = np.asarray(want)
    atol = rtol * float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=atol)


def check_csr(got, want, values=bitwise):
    """A rank's CSR (dict of arrays) against a JAX or scipy CSR."""
    bitwise(got["indptr"], want.indptr)
    bitwise(got["indices"], want.indices)
    values(got["data"], want.data)


@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_shard_roundtrip(ranks, mesh, balance):
    A = case()
    Ash = jpp.shard_csr(A, mesh, balance=balance)
    y = jpp.spmm_sharded(Ash, jnp.eye(A.shape[1], dtype=A.dtype), mesh)
    want = jpp.unshard_rows(y, A.shape[0], Ash.row_bounds)
    for r, out in enumerate(ranks.run("shard", a=arrays(A), balance=balance,
                                      layout=balance == "nnz")):
        assert out["n_shards"] == Ash.n_shards == D
        assert out["nnz"] == Ash.nnz == A.nnz
        assert out["row_bounds"] == Ash.row_bounds
        assert out["rows_per_shard"] == Ash.rows_per_shard
        assert out["nnz_per"] == tuple(np.asarray(Ash.nnz_local).tolist())
        assert out["nnz_local"] == int(np.asarray(Ash.nnz_local)[r])
        for k in ("indptr", "indices", "data"):
            bitwise(out[k], np.asarray(getattr(Ash, k))[r])
        bitwise(out["eye_local"], np.asarray(y)[r])
        bitwise(out["eye"], want)


@pytest.mark.parametrize("balance", ["nnz", "rows"])
def test_spmv_sharded(ranks, mesh, balance):
    """Both sum each row in CSR order from +0.0: bitwise."""
    A = case()
    x = np.random.default_rng(1).random(A.shape[1], dtype=np.float32)
    Ash = jpp.shard_csr(A, mesh, balance=balance)
    y = jpp.spmv_sharded(Ash, jnp.asarray(x), mesh)
    want = jpp.unshard_rows(y, A.shape[0], Ash.row_bounds)
    for r, out in enumerate(ranks.run("spmv", a=arrays(A), x=x,
                                      balance=balance)):
        bitwise(out["local"], np.asarray(y)[r])
        bitwise(out["global"], want)
    close(want, A.to_scipy() @ x, rtol=1e-5)


def test_spmv_sharded_streamed(ranks, mesh):
    """The plan, the x blocks and the streamed SpMV are JAX's, bitwise;
    the streamed result is bitwise the blocked twin's, and its rerun's."""
    A = case(m=97, n=83, d=0.15, seed=7)
    x = np.random.default_rng(11).standard_normal(A.shape[1]) \
        .astype(np.float32)
    Ash = jpp.shard_csr(A, mesh, balance="nnz")
    plan = jpp.spmv_stream_plan(Ash, mesh)
    xs = jpp.shard_vector(jnp.asarray(x), mesh)
    y = jpp.spmv_sharded_streamed(plan, xs, mesh)
    want = jpp.unshard_rows(y, A.shape[0], Ash.row_bounds)
    for r, out in enumerate(ranks.run("stream", a=arrays(A), x=x,
                                      balance="nnz")):
        assert (out["nb"], out["Eb"]) == (plan.nb, plan.Eb)
        for k in ("rows", "cols", "data"):
            bitwise(out[k], np.asarray(getattr(plan, k))[r])
        bitwise(out["xs"], np.asarray(xs)[r])
        bitwise(out["local"], out["blocked"])
        bitwise(out["local"], out["again"])
        bitwise(out["local"], np.asarray(y)[r])
        bitwise(out["global"], want)
    close(want, A.to_scipy() @ x, rtol=1e-5)


def test_spmv_sharded_streamed_empty_and_skew(ranks, mesh):
    """Empty rows, a rank with no entries for some blocks, n not divisible
    by D, the plan made inside the call; and the nnz balance of the same
    matrix, which leaves ranks with no rows."""
    rng = np.random.default_rng(3)
    m, n = 33, 51
    dense = np.zeros((m, n), np.float32)
    dense[0, :] = rng.standard_normal(n)  # one hot row
    dense[20, 5] = 2.5
    As = sp.csr_matrix(dense)
    A = st.CSR.from_scipy(As)
    x = rng.standard_normal(n).astype(np.float32)
    for balance in ("rows", "nnz"):
        Ash = jpp.shard_csr(A, mesh, balance=balance)
        y = jpp.spmv_sharded_streamed(
            Ash, jpp.shard_vector(jnp.asarray(x), mesh), mesh)
        want = jpp.unshard_rows(y, m, Ash.row_bounds)
        outs = ranks.run("stream", a=arrays(A), x=x, balance=balance,
                         use_plan=False)
        for r, out in enumerate(outs):
            bitwise(out["local"], out["blocked"])
            bitwise(out["local"], np.asarray(y)[r])
            bitwise(out["global"], want)
        close(want, As @ x, rtol=1e-5)
    assert Ash.row_bounds[-2] == m  # a rank of the nnz balance has no rows


def test_spmv_t_sharded_psum(ranks, mesh):
    A = case()
    Ash = jpp.shard_csr(A, mesh)
    y_np = np.random.default_rng(2).random(A.shape[0], dtype=np.float32)
    y_blocks = np.zeros((D, Ash.rows_per_shard), np.float32)
    for i in range(D):
        r0, r1 = Ash.row_bounds[i], Ash.row_bounds[i + 1]
        y_blocks[i, :r1 - r0] = y_np[r0:r1]
    y_sh = jax.device_put(jnp.asarray(y_blocks),
                          NamedSharding(mesh, P("rows")))
    want = np.asarray(jpp.spmv_t_sharded(Ash, y_sh, mesh))
    outs = ranks.run("spmv_t", a=arrays(A), y=y_np)
    for out in outs:
        close(out["x"], want)
        bitwise(out["x"], outs[0]["x"])  # one order on every rank
    close(want, A.to_scipy().T @ y_np, rtol=1e-4)


def test_spmm_sharded(ranks, mesh):
    A = case()
    B = np.random.default_rng(3).random((A.shape[1], 19), dtype=np.float32)
    Ash = jpp.shard_csr(A, mesh, balance="nnz")
    C = jpp.spmm_sharded(Ash, jnp.asarray(B), mesh)
    want = jpp.unshard_rows(C, A.shape[0], Ash.row_bounds)
    for r, out in enumerate(ranks.run("spmm", a=arrays(A), b=B,
                                      balance="nnz")):
        close(out["local"], np.asarray(C)[r])
        close(out["global"], want)


def test_spgemm_dense_sharded(ranks, mesh):
    A = case(m=64, n=48, d=0.2)
    B = st.random(48, 56, density=0.2, format="csr", random_state=5)
    Ash = jpp.shard_csr(A, mesh)
    C = jpp.spgemm_dense_sharded(Ash, B.toarray(), mesh)
    want = jpp.unshard_rows(C, A.shape[0], Ash.row_bounds)
    bd = np.asarray(B.toarray())
    for r, out in enumerate(ranks.run("spgemm_dense", a=arrays(A), b=bd)):
        close(out["local"], np.asarray(C)[r])
        close(out["global"], want)
    close(want, (A.to_scipy() @ B.to_scipy()).toarray(), rtol=1e-5)


def test_all_gather_csr_blocks(ranks, mesh):
    A = case(m=40, n=30, d=0.2)
    Ash = jpp.shard_csr(A, mesh)
    want = jpc.all_gather_csr_blocks(Ash, mesh)
    for out in ranks.run("all_gather_csr", a=arrays(A)):
        for g, w in zip(out, want):
            bitwise(g, w)
        assert int(out[3].sum()) == A.nnz


def test_psum_dense(ranks, mesh):
    x = np.random.default_rng(0).random((D, 16), dtype=np.float32)
    x_sh = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("rows")))
    want = jpc.psum_dense(x_sh, mesh, "rows")
    for out in ranks.run("psum", x=x):
        close(out["sum"], want)
        bitwise(out["sum"], ((x[0] + x[1]) + x[2]) + x[3])  # rank order


def test_barrier(ranks, mesh):
    assert jpc.barrier(mesh, "rows") is None
    for out in ranks.run("barrier"):
        assert out == {"first": None, "second": None}


@pytest.mark.parametrize("b_axis", ["x", "y"])
def test_spgemm_summa_2d(ranks, mesh2, b_axis):
    """B sharded on "x" (JAX's test) and on "y" (the k-blocks SUMMA
    contracts over); rank (x, y) holds block (x, y) of JAX's P("x", "y")
    product."""
    A = st.random(48, 40, density=0.2, format="csr", random_state=0)
    B = st.random(40, 36, density=0.2, format="csr", random_state=1)
    Ash = jpp.shard_csr(A, mesh2, axis="x")
    Bsh = jpp.shard_csr(B, mesh2, axis=b_axis)
    C = jsumma.spgemm_summa(Ash, Bsh, mesh2)
    assert C.sharding.spec == P("x", "y")
    want = np.asarray(C)
    outs = ranks.run("summa", a=arrays(A), b=arrays(B), b_axis=b_axis)
    for out in outs:
        x, y = out["coords"]
        close(out["local"], want[x * 24:(x + 1) * 24, y * 18:(y + 1) * 18])
        close(out["global"], want)
    close(want, (A.to_scipy() @ B.to_scipy()).toarray(), rtol=1e-5)


def test_sparse_all_reduce(ranks, mesh):
    """Both sum each position's run in (rank, row, column) order from
    +0.0: bitwise, on every rank."""
    mats = [st.random(30, 25, 0.1, format="csr", random_state=i)
            for i in range(D)]
    want = jpc.all_reduce_csr(mats, mesh, "rows")
    for out in ranks.run("all_reduce", mats=[arrays(m) for m in mats]):
        check_csr(out, want)


def test_sparse_ppermute_ring_and_broadcast(ranks, mesh):
    mats = [st.random(20, 22, 0.15, format="csr", random_state=10 + i)
            for i in range(D)]
    cap = max(m.nnz for m in mats)
    wires = [jpc.pad_csr(m, cap) for m in mats]
    parts = tuple(jnp.stack([w[i] for w in wires]) for i in range(4))
    ring = jpc.ppermute_csr(parts, mesh, "rows",
                            [(i, (i + 1) % D) for i in range(D)])
    bcast = jpc.broadcast_csr(parts, mesh, "rows", root=D - 1)
    for r, out in enumerate(ranks.run("ppermute_bcast",
                                      mats=[arrays(m) for m in mats])):
        for c in range(4):
            bitwise(out["ring"][c], np.asarray(ring[c])[r])
            bitwise(out["bcast"][c], np.asarray(bcast[c])[r])


def test_sparse_all_to_all(ranks, mesh):
    mats = [[st.random(6, 8, 0.3, format="csr", random_state=i * D + j)
             for j in range(D)] for i in range(D)]
    cap = max(m.nnz for row in mats for m in row)
    wires = [[jpc.pad_csr(m, cap) for m in row] for row in mats]
    parts = tuple(
        jnp.stack([jnp.stack([wires[i][j][c] for j in range(D)])
                   for i in range(D)]) for c in range(4))
    want = jpc.all_to_all_csr(parts, mesh, "rows")
    outs = ranks.run("all_to_all",
                     mats=[[arrays(m) for m in row] for row in mats])
    for j, out in enumerate(outs):
        for c in range(4):
            bitwise(out[c], np.asarray(want[c])[j])
        for i in range(D):  # rank j's block i is rank i's block j
            got = sp.csr_matrix((out[2][i][:out[3][i]],
                                 out[1][i][:out[3][i]], out[0][i]),
                                shape=(6, 8))
            np.testing.assert_array_equal(got.toarray(),
                                          mats[i][j].to_scipy().toarray())


@pytest.mark.parametrize("stream_b", [True, False])
def test_spgemm_sharded_sparse(ranks, mesh, stream_b):
    """indptr, indices and every nnz bitwise JAX's; values within 1e-6."""
    A = st.random(96, 80, 0.15, format="csr", random_state=1)
    B = st.random(80, 72, 0.12, format="csr", random_state=2)
    C = jsharded.spgemm_sharded_sparse(jpp.shard_csr(A, mesh),
                                  jpp.shard_csr(B, mesh), mesh,
                                  stream_b=stream_b)
    Cg = jsharded.sharded_to_csr(C)
    nnz = tuple(np.asarray(C.nnz_local).tolist())
    for r, out in enumerate(ranks.run("spgemm_sparse", a=arrays(A),
                                      b=arrays(B), stream_b=stream_b)):
        assert out["nnz_per"] == nnz
        bitwise(out["indptr"], np.asarray(C.indptr)[r])
        bitwise(out["indices"], np.asarray(C.indices)[r])
        close(out["data"], np.asarray(C.data)[r])
        check_csr(out["csr"], Cg, values=close)
    ref = (A.to_scipy() @ B.to_scipy()).tocsr()
    ref.sort_indices()
    check_csr(out["csr"], ref, values=lambda g, w: close(g, w, 2e-5))


def test_spgemm_sharded_streamed_vs_replicated(ranks, mesh):
    """The ring and the replicated path give one structure, JAX's, with B
    balanced by nnz; the ring reruns bitwise."""
    A = st.random(120, 100, 0.12, format="csr", random_state=7)
    B = st.random(100, 88, 0.1, format="csr", random_state=8)
    Ash = jpp.shard_csr(A, mesh)
    Bsh = jpp.shard_csr(B, mesh, balance="nnz")
    Cs = jsharded.sharded_to_csr(jsharded.spgemm_sharded_sparse(Ash, Bsh, mesh,
                                                      stream_b=True))
    kw = dict(a=arrays(A), b=arrays(B), balance_b="nnz")
    streamed = ranks.run("spgemm_sparse", stream_b=True, rerun=True, **kw)
    replicated = ranks.run("spgemm_sparse", stream_b=False, **kw)
    for s, p in zip(streamed, replicated):
        check_csr(s["csr"], Cs, values=close)
        bitwise(s["csr"]["indptr"], p["csr"]["indptr"])
        bitwise(s["csr"]["indices"], p["csr"]["indices"])
        close(s["csr"]["data"], p["csr"]["data"], rtol=4e-7)
        bitwise(s["again"], s["data"])


@pytest.mark.parametrize("precision", ["high", "default"])
def test_spgemm_sharded_sparse_precision(ranks, mesh, precision):
    """The precision modes: IEEE float32 on the CPU in both packages."""
    A = st.random(64, 56, 0.15, format="csr", random_state=3)
    B = st.random(56, 40, 0.15, format="csr", random_state=4)
    C = jsharded.sharded_to_csr(jsharded.spgemm_sharded_sparse(
        jpp.shard_csr(A, mesh), jpp.shard_csr(B, mesh), mesh,
        precision=precision))
    for out in ranks.run("spgemm_sparse", a=arrays(A), b=arrays(B),
                         stream_b=True, precision=precision):
        check_csr(out["csr"], C, values=close)


def test_spgemm_summa_sparse_blocks(ranks, mesh2):
    A = st.random(64, 48, density=0.15, format="csr", random_state=1)
    B = st.random(48, 40, density=0.2, format="csr", random_state=2)
    Ash = jpp.shard_csr(A, mesh2, axis="x")
    Bsh = jpp.shard_csr(B, mesh2, axis="y")
    blocks = jsumma.spgemm_summa_sparse(Ash, Bsh, mesh2)
    Cs = jsumma.summa_blocks_to_csr(blocks, (64, 40))
    rows, cols, vals, nnz = (np.asarray(b) for b in blocks)
    for r, out in enumerate(ranks.run("summa", a=arrays(A), b=arrays(B),
                                      b_axis="y", sparse=True)):
        x, y = divmod(r, 2)
        got = out["blocks"]
        assert int(got[3]) == nnz[x, y]
        bitwise(got[0], rows[x, y])
        bitwise(got[1], cols[x, y])
        close(got[2], vals[x, y])
        check_csr(out["csr"], Cs, values=close)


def test_sparse_send_recv_scatter_gather(ranks, mesh):
    mats = [st.random(12, 14, 0.2, format="csr", random_state=40 + i)
            for i in range(D)]
    parts = jpc.scatter_csr(mats, mesh, "rows")
    sent = jpc.send_recv_csr(parts, mesh, "rows", 0, D - 1)
    back = jpc.gather_csr(parts, mesh, "rows", shape=(12, 14))
    outs = ranks.run("scatter_gather", mats=[arrays(m) for m in mats],
                     shape=(12, 14))
    for r, out in enumerate(outs):
        for c in range(4):
            bitwise(out["scatter"][c], np.asarray(parts[c])[r])
            bitwise(out["send_recv"][c], np.asarray(sent[c])[r])
        for d in range(D):
            check_csr(out["gather"][d], back[d])


def test_reduce_scatter_dense(ranks, mesh):
    x = np.random.default_rng(5).random((D, D * 6, 13), dtype=np.float32)
    want = np.asarray(jpc.reduce_scatter_dense(jnp.asarray(x), mesh, "rows"))
    for r, out in enumerate(ranks.run("reduce_scatter_dense", x=x)):
        close(out["out"], want[r * 6:(r + 1) * 6])
        bitwise(out["out"], (((x[0] + x[1]) + x[2]) + x[3])[r * 6:
                                                              (r + 1) * 6])


def test_reduce_scatter_csr(ranks, mesh):
    m = D * 8
    mats = [st.random(m, 21, 0.15, format="csr", random_state=10 + i)
            for i in range(D)]
    blocks = jpc.reduce_scatter_csr(mats, mesh, "rows")
    for r, out in enumerate(ranks.run("reduce_scatter_csr",
                                      mats=[arrays(a) for a in mats])):
        check_csr(out, blocks[r])


# ---------------------------------------------------------------------------
# the port's own: the mesh's refusals and the launcher
# ---------------------------------------------------------------------------


def test_mesh_value_errors(ranks):
    """make_mesh's ValueErrors, JAX's words where JAX has them, and a
    replicated layout refused by shard_csr."""
    for out in ranks.run("mesh_errors"):
        assert out["count"] and "5 devices" in out["count"]
        assert out["shape"] == "shape required for multi-axis meshes"
        assert out["product"] == "mesh shape (4, 2) != 4 devices"
        assert out["mesh_2d"] == "mesh 4x2 needs 8 devices, have 4"
        assert out["replicated"] and "replicated" in out["replicated"]


def test_no_card_refused(monkeypatch, tmp_path):
    """With no card and no device="cpu", the mesh and the process group
    raise; nothing falls back to the CPU or to gloo."""
    import torch

    from spmm_tpu_torch import parallel as pp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pp.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pp.init_process_group(store_path=str(tmp_path / "s"), world_size=1,
                              rank=0)
    assert not torch.distributed.is_initialized()


def test_two_nccl_ranks_on_one_card_refused(tmp_path):
    """Two ranks of one host on cuda:0: every rank raises before a process
    group is made (NCCL would fail later with "Duplicate GPU detected")."""
    import torch

    from spmm_tpu_torch import parallel as pp

    errors = [None, None]

    def join(r):
        try:
            pp.init_process_group(store_path=str(tmp_path / "s"),
                                  world_size=2, rank=r, device="cuda:0",
                                  timeout_s=30)
        except ValueError as e:
            errors[r] = str(e)

    threads = [threading.Thread(target=join, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for e in errors:
        assert e and "ranks 0 and 1" in e and "cuda:0" in e
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="one card"):
        pp.mesh.refuse_shared_cards(["h/cpu", "h/cuda:1", "g/cuda:1",
                                     "h/cuda:1"])


def test_launcher_runs_comm_runner():
    """Two gloo ranks of comm_runner (Aᵀ(A·1) against scipy) through the
    launcher; both exit 0."""
    done = subprocess.run(
        [sys.executable, "-m", "spmm_tpu_torch.experiments.distributed",
         "--nprocs", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert done.returncode == 0, done.stdout + done.stderr
    oks = [ln for ln in done.stdout.splitlines() if "] OK" in ln]
    assert len(oks) == 2, done.stdout
    assert "MULTIPROCESS OK (2 ranks)" in done.stdout
