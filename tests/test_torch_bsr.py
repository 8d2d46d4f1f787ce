"""The port's BSR SpMM (kernel `bsr_spmm`, `spmm(via="bsr"/"bsr_pallas")`,
`A_bsr @ X`), `csr_densify_mxu`, the element-wise ops, the matrix families
and the containers slice as a whole, against the JAX package.

Inputs are made with numpy and handed to both packages; the JAX Pallas
kernels run in interpret mode, as tests/test_kernels.py and
tests/test_densify_mxu.py run them on the CPU.  On the CPU the port's
wrappers run their plain versions (`tests/test_torch_cuda.py` runs the
kernels on the card).

Tolerances: the BSR products sum the same float32 terms as JAX in another
order (torch's bmm against XLA's dot, the kernel's one fmaf chain), so
they are held to rtol 1e-5 and atol 1e-6 * max|C| (about eight float32
ulps of the largest value, for sums of at most a few hundred terms here),
and to scipy's float64 product at rtol 1e-4 / atol 1e-5, the JAX tests'
bound.  `csr_densify_mxu` moves values and is bitwise.  The element-wise
sums are the in-order duplicate sum and bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.models import power_law_rows as jax_power_law  # noqa: E402
from spmm_tpu.ops.kernels.bsr_spmm import spmm_bsr_pallas  # noqa: E402
from spmm_tpu.ops.kernels.densify_mxu import (  # noqa: E402
    csr_densify_mxu as jax_densify_mxu)
from spmm_tpu.ops.spmm import _bsr_spmm as jax_bsr_spmm  # noqa: E402
from spmm_tpu_torch.models import (banded, block_sparse,  # noqa: E402
                                   power_law_rows, uniform)
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels.bsr_spmm import (  # noqa: E402
    bsr_spmm, bsr_spmm_plain, spmm_bsr)
from spmm_tpu_torch.ops.kernels.densify_mxu import (  # noqa: E402
    csr_densify_mxu, csr_densify_mxu_plain)
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, assert_same, sparse_pair)


def assert_close(got, want, rtol=1e-5):
    """rtol and atol = 1e-6 * max|want|: two float32 orders of one sum."""
    w = np.asarray(want, np.float64)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape
    atol = 1e-6 * float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def assert_vs_scipy(got, a_ref, b):
    want = a_ref.to_scipy().astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _dense_b(k, n, seed):
    return np.random.default_rng(seed).random((k, n), dtype=np.float32)


def _block_pair(m, n, block, block_density, seed):
    """The same block-structured matrix in both packages: dense (R, C)
    blocks at numpy-drawn places (the families draw with their own
    generators, so the arrays are made here)."""
    R, C = block
    mb, nb = m // R, n // C
    rng = np.random.default_rng(seed)
    nblocks = max(1, int(block_density * mb * nb))
    flat = rng.choice(mb * nb, size=nblocks, replace=False)
    vals = rng.random((nblocks, R, C), dtype=np.float32)
    rr = (np.repeat(flat // nb, R * C) * R
          + np.tile(np.repeat(np.arange(R), C), nblocks))
    cc = (np.repeat(flat % nb, R * C) * C
          + np.tile(np.arange(C), nblocks * R))
    args = ((vals.reshape(-1), (rr.astype(np.int32), cc.astype(np.int32))),)
    return (st.COO(*args, shape=(m, n)).tocsr(),
            pt.COO(*args, shape=(m, n), device="cpu").tocsr())


# ------------------------------------------ bsr_spmm (tests/test_kernels.py)


@pytest.mark.parametrize("blocksize", [(8, 128), (16, 128)])
def test_bsr_spmm_pallas_parity(blocksize):
    a_ref, a = sparse_pair(64, 256, 0.05, 0)
    ab_ref, ab = a_ref.tobsr(blocksize=blocksize), a.tobsr(blocksize=blocksize)
    assert_same(ab, ab_ref)
    b = _dense_b(256, 128, 1)
    got = spmm_bsr(ab, torch.from_numpy(b))
    assert_close(got, spmm_bsr_pallas(ab_ref, jnp.asarray(b), interpret=True))
    assert_vs_scipy(got, a_ref, b)


def test_bsr_spmm_pallas_ragged_shapes():
    # K, N not multiples of the block and the tile: the kernel masks, the
    # TPU wrapper pads
    a_ref, a = sparse_pair(40, 200, 0.1, 2)
    ab_ref, ab = a_ref.tobsr(blocksize=(8, 128)), a.tobsr(blocksize=(8, 128))
    b = _dense_b(200, 70, 3)
    got = spmm_bsr(ab, torch.from_numpy(b))
    assert got.shape == (40, 70)
    assert_close(got, spmm_bsr_pallas(ab_ref, jnp.asarray(b), interpret=True))
    assert_vs_scipy(got, a_ref, b)


def test_bsr_spmm_pallas_empty():
    ab_ref = st.CSR((16, 256), dtype=jnp.float32).tobsr(blocksize=(8, 128))
    ab = pt.CSR((16, 256), device="cpu").tobsr(blocksize=(8, 128))
    b = np.ones((256, 128), np.float32)
    got = spmm_bsr(ab, torch.from_numpy(b))
    assert got.shape == (16, 128) and not got.any()
    assert_bitwise(got, np.asarray(spmm_bsr_pallas(ab_ref, jnp.asarray(b),
                                                   interpret=True)))
    # a block row with no blocks writes zeros
    a_ref, a = sparse_pair(24, 256, 0.05, 5)
    keep = a.tocoo().row >= 8
    a = pt.COO((a.tocoo().data[keep], (a.tocoo().row[keep],
                                       a.tocoo().col[keep])), shape=a.shape)
    ab = a.tobsr()
    assert ab.indptr[1] == 0
    out = spmm_bsr(ab, torch.from_numpy(b))
    assert not out[:8].any()
    assert_close(out, a.toarray().double().numpy() @ b.astype(np.float64))


def test_bsr_spmm_pallas_block_structured():
    a_ref, a = _block_pair(128, 512, (8, 128), 0.3, 4)
    ab_ref, ab = a_ref.tobsr(blocksize=(8, 128)), a.tobsr(blocksize=(8, 128))
    assert_same(ab, ab_ref)
    b = _dense_b(512, 256, 5)
    got = spmm_bsr(ab, torch.from_numpy(b))
    assert_close(got, spmm_bsr_pallas(ab_ref, jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got.numpy(),
                               a_ref.to_scipy().astype(np.float64) @ b,
                               rtol=1e-4, atol=1e-4)


def test_bsr_spmm_wrapper_checks():
    _, a = sparse_pair(16, 256, 0.05, 6)
    ab = a.tobsr()
    b = torch.ones(256, 8)
    with pytest.raises(ValueError, match="cover"):
        bsr_spmm(ab.indptr, ab.indices, ab.data, b, 40)
    with pytest.raises(ValueError, match="float32"):
        bsr_spmm(ab.indptr, ab.indices, ab.data, b.double(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm(ab.indptr, ab.indices, ab.data, torch.ones(8, 256).T, 16)
    # the plain version is the one a CPU tensor runs, no launch counted
    before = dict(_build.LAUNCHES)
    assert_bitwise(bsr_spmm(ab.indptr, ab.indices, ab.data, b, 16),
                   bsr_spmm_plain(ab.indptr, ab.indices, ab.data, b, 16))
    assert _build.LAUNCHES == before


# -------------------------------------------- spmm's BSR routes and `@`


def test_spmm_via_bsr_vs_jax_bsr_spmm():
    a_ref, a = sparse_pair(96, 72, 0.2, 0)
    ab_ref, ab = a_ref.tobsr(blocksize=(8, 16)), a.tobsr(blocksize=(8, 16))
    b = _dense_b(72, 33, 1)
    want = jax_bsr_spmm(ab_ref.indptr, ab_ref.indices, ab_ref.data,
                        jnp.asarray(b), jnp.float32(1.0))[:96]
    assert_close(pt.spmm(ab, b), want)
    assert_close(pt.spmm(a, b, via="bsr"), st.spmm(a_ref, jnp.asarray(b),
                                                   via="bsr"))


@pytest.mark.parametrize("via", ["csr", "dense", "bsr", "bsr_pallas"])
@pytest.mark.parametrize("density", [0.01, 0.2])
def test_spmm_parity(via, density):
    a_ref, a = sparse_pair(96, 72, density, 0)
    b = _dense_b(72, 33, 1)
    got = pt.spmm(a, b, via=via)
    assert_close(got, st.spmm(a_ref, jnp.asarray(b), via=via))
    assert_vs_scipy(got, a_ref, b)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc", "bsr", "dia"])
def test_matmul_every_format(fmt):
    a_ref, a = sparse_pair(40, 30, 0.2, 7, fmt)
    b = _dense_b(30, 9, 8)
    x = b[:, 0].copy()
    assert_close(a @ b, a_ref @ jnp.asarray(b))
    assert_close(a @ x, a_ref @ jnp.asarray(x))
    assert_close(pt.spmm(a, b, alpha=0.5), st.spmm(a_ref, jnp.asarray(b),
                                                   alpha=0.5))
    y = _dense_b(5, 40, 9)
    assert_close(y @ a, jnp.asarray(y) @ a_ref)
    # a sparse rhs of any format goes to SpGEMM through CSR
    b_ref, bs = sparse_pair(30, 20, 0.2, 10, fmt)
    assert_close((a @ bs).toarray(), (a_ref @ b_ref).toarray())
    if fmt != "csr":  # spgemm takes CSR operands only, as in JAX
        with pytest.raises(TypeError):
            pt.spgemm(a, bs)


def test_spmm_bsr_transa():
    a_ref, a = sparse_pair(40, 30, 0.2, 0)
    b = _dense_b(40, 7, 1)
    for via in ("bsr", "bsr_pallas"):
        got = pt.spmm(a.tobsr(blocksize=(8, 16)), b, transa=True, via=via)
        assert_close(got, st.spmm(a_ref.tobsr(blocksize=(8, 16)),
                                  jnp.asarray(b), transa=True, via=via))


# ------------------------------------ csr_densify_mxu (test_densify_mxu.py)


@pytest.mark.parametrize("shape,d", [((100, 130), 0.15), ((300, 257), 0.05),
                                     ((64, 64), 0.5), ((128, 1024), 0.01)])
def test_densify_mxu_parity(shape, d):
    m, k = shape
    a_ref, a = sparse_pair(m, k, d, 0)
    got = csr_densify_mxu(a.indptr, a.indices, a.data, m, k)
    want = jax_densify_mxu(a_ref.indptr, a_ref.indices, a_ref.data, m, k,
                           interpret=True)
    assert_bitwise(got, np.asarray(want))
    assert_bitwise(got, a.toarray())
    np.testing.assert_array_equal(got.numpy(), a_ref.to_scipy().toarray())


def test_densify_mxu_empty():
    a_ref = st.CSR((16, 32), dtype=jnp.float32)
    a = pt.CSR((16, 32), device="cpu")
    got = csr_densify_mxu(a.indptr, a.indices, a.data, 16, 32)
    assert_bitwise(got, np.asarray(jax_densify_mxu(
        a_ref.indptr, a_ref.indices, a_ref.data, 16, 32, interpret=True)))


def test_densify_mxu_skewed_rows():
    a_ref = jax_power_law(200, 300, avg_nnz_per_row=20, seed=3)
    a = power_law_rows(200, 300, 20, seed=3, device="cpu")
    got = csr_densify_mxu(a.indptr, a.indices, a.data, 200, 300)
    assert_bitwise(got, np.asarray(jax_densify_mxu(
        a_ref.indptr, a_ref.indices, a_ref.data, 200, 300, interpret=True)))


def test_densify_mxu_dtype_and_canonical_input():
    a_ref, a = sparse_pair(50, 40, 0.2, 1)
    d64 = a.data.double() / 3
    got = csr_densify_mxu(a.indptr, a.indices, d64, 50, 40)
    assert got.dtype == torch.float64  # densified in float32, cast back
    want = jax_densify_mxu(a_ref.indptr, a_ref.indices,
                           jnp.asarray(d64.float().numpy()), 50, 40,
                           interpret=True)
    assert_bitwise(got.float(), np.asarray(want))
    assert_bitwise(csr_densify_mxu_plain(a.indptr, a.indices, d64, 50, 40),
                   got)
    u = pt.CSR.from_parts(np.array([0, 2], np.int32),
                          np.array([3, 1], np.int32),
                          np.ones(2, np.float32), (1, 4), device="cpu")
    with pytest.raises(ValueError, match="canonical"):
        csr_densify_mxu(u.indptr, u.indices, u.data, 1, 4)


# ------------------------------------------ element-wise ops (test_ops.py)


def test_add_sub_multiply():
    a_ref, a = sparse_pair(30, 40, 0.2, 0)
    b_ref, b = sparse_pair(30, 40, 0.2, 5)
    for got, want in ((a + b, a_ref + b_ref), (a - b, a_ref - b_ref),
                      (a.multiply(b), a_ref.multiply(b_ref))):
        assert_same(got, want)
    S = a_ref.to_scipy() + b_ref.to_scipy()
    np.testing.assert_allclose((a + b).toarray().numpy(), S.toarray(),
                               rtol=1e-6)
    # a run of three duplicates sums in stored order, as JAX
    c_ref, c = sparse_pair(30, 40, 0.2, 5, "coo")
    assert_same(a + b + c, a_ref + b_ref + c_ref)
    # another format stays in its format
    assert_same(a.tocsc() + b, a_ref.tocsc() + b_ref)


def test_multiply_dense_broadcast():
    a_ref, a = sparse_pair(30, 40, 0.2, 0)
    rng = np.random.default_rng(1)
    for shape in ((30, 40), (40,), (1, 40), (30, 1), ()):
        d = rng.random(shape, dtype=np.float32) if shape else np.float32(3)
        assert_same(a.multiply(d), a_ref.multiply(jnp.asarray(d)))
    with pytest.raises(ValueError, match="broadcast"):
        a.multiply(np.ones((3, 3), np.float32))
    d = rng.random((30, 40), dtype=np.float32)
    assert_bitwise(a + d, np.asarray(a_ref + jnp.asarray(d)))


# ------------------------------------------------------ matrix families


def test_block_sparse_family():
    a = block_sparse(128, 512, (8, 128), 0.3, seed=4, device="cpu")
    b = a.tobsr(blocksize=(8, 128))
    assert a.nnz == int(0.3 * 16 * 4) * 8 * 128
    assert b.nblocks == int(0.3 * 16 * 4)
    assert bool((b.data > 0).all())  # each stored block is dense
    again = block_sparse(128, 512, (8, 128), 0.3, seed=4, device="cpu")
    assert_bitwise(again.data, a.data)
    assert block_sparse(64, 64, (32, 32), 0.0, device="cpu",
                        format="bsr").nnz > 0  # at least one block


def test_banded_and_uniform_families():
    a = banded(12, 10, 2, seed=1, device="cpu")
    dense = a.toarray().numpy()
    i, j = np.nonzero(dense)
    assert np.abs(i - j).max() <= 2 and a.nnz == np.count_nonzero(dense)
    u = uniform(20, 30, 0.2, seed=2, low=5.0, high=6.0, device="cpu",
                format="coo")
    assert u.format == "coo" and u.nnz == 120
    assert float(u.data.min()) >= 5.0 and float(u.data.max()) < 6.0


# ------------------------------------------------- the slice as a whole


def test_containers_slice_chain():
    """A COO through every format to spmm and `@`, against JAX's same
    chain on the same arrays."""
    a_ref, a = sparse_pair(72, 300, 0.04, 11, "coo")
    assert_same(a, a_ref)
    b = _dense_b(300, 40, 12)
    csr, csr_ref = a.tocsr(), a_ref.tocsr()
    assert_same(csr, csr_ref)
    assert_same(csr.tocsc(), csr_ref.tocsc())
    bsr, bsr_ref = csr.tocsc().tobsr(), csr_ref.tocsc().tobsr()
    assert_same(bsr, bsr_ref)
    assert_same(bsr.todia(), bsr_ref.todia())
    assert_same(bsr.todia().tocoo(), bsr_ref.todia().tocoo())
    for via in ("csr", "bsr", "bsr_pallas"):
        assert_close(pt.spmm(bsr, b, via=via),
                     st.spmm(bsr_ref, jnp.asarray(b), via=via))
    assert_close(bsr @ b, bsr_ref @ jnp.asarray(b))
    assert_close(a.todia() @ b, a_ref.todia() @ jnp.asarray(b))
    assert_vs_scipy(bsr @ b, a_ref, b)
