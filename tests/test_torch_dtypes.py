"""Dtypes and precision modes of the PyTorch port against the JAX package.

Twins of tests/test_spgemm_dtypes.py (float32, float64, complex64 and
complex128 across the algs and engines, rerun stability, mixed-operand
promotion, wide SpMV/SpMM, an empty wide product) and tests/test_dtypes.py
(bfloat16), with their parametrisations; the case alg 1 x impl "esc",
which the JAX test skips, is left out of the grid.  Each test builds its
inputs once from a seed with numpy and runs the same host arrays through
JAX (x64 enabled as a context, as the JAX tests do) and through the port
on the CPU.  Structure is held bitwise; float64 values bitwise where the
path is data movement or ESC's fixed tree, elsewhere within `_tol` of the
JAX file (1e-5 or 1e-12 x max|C|); bfloat16 values within 2 bf16 ulps.

Then the precision modes: on the CPU torch has no TF32, so every mode is
IEEE float32 in the port, as every mode is in JAX's CPU backend, and each
is held against JAX's output in that mode at the "highest" tolerance; the
"high" split's arithmetic (`spgemm.tf32x3_matmul`, TF32 operands, float32
sums) is held against float64 at the card's 1e-6 gate, which one TF32 pass
misses by far.  The card runs the split itself in tests/test_torch_cuda.py
and chip_smoke.py phase 16.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.sparse.csr import CSR  # noqa: E402
from spmm_tpu_torch.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot, densify_onehot_windows)
from spmm_tpu_torch.ops.kernels.extract_roll import (  # noqa: E402
    extract_roll, extract_roll_tiles)
from torch_port_helpers import (as_bits, assert_bitwise,  # noqa: E402
                                assert_same, coo_arrays, csr_arrays, pair)

# the module, not the function `spmm_tpu_torch.ops.spgemm` re-exports
sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
IDS = [np.dtype(d).name for d in DTYPES]
ALG_IMPL = [(1, "dense"), (2, "dense"), (2, "esc"), (3, "dense"),
            (3, "esc")]


def _make_pair(dt, m=40, k=36, n=30, da=0.15, db=0.12, seed=0):
    """The JAX file's `_make_pair`: scipy structures, values from `seed`."""
    rng = np.random.default_rng(seed)
    As = sp.random(m, k, da, format="csr", random_state=1)
    Bs = sp.random(k, n, db, format="csr", random_state=2)

    def vals(nnz):
        v = rng.standard_normal(nnz)
        if np.issubdtype(dt, np.complexfloating):
            v = v + 1j * rng.standard_normal(nnz)
        return v.astype(dt)

    As.data, Bs.data = vals(As.nnz), vals(Bs.nnz)
    return As, Bs


def _tol(dt):
    return 1e-5 if np.dtype(dt).itemsize <= 8 else 1e-12


def _port(mat):
    return pt.CSR.from_scipy(mat, device="cpu")


def _close(got, want, tol):
    """Port values within tol * max|want| of JAX's."""
    w = np.asarray(want)
    g = got.detach().cpu().numpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(scale, 1e-30))


def _same_structure(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert got.has_canonical_format == want.has_canonical_format
    assert_bitwise(got.indptr, np.asarray(want.indptr))
    assert_bitwise(got.indices, np.asarray(want.indices))


# -- tests/test_spgemm_dtypes.py --------------------------------------------


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("alg,impl", ALG_IMPL)
def test_spgemm_dtype_parity(dt, alg, impl):
    with jax.enable_x64(True):
        As, Bs = _make_pair(dt)
        alpha = 2.0 + (0.5j if np.issubdtype(dt, np.complexfloating)
                       else 0.0)
        want = st.spgemm(CSR.from_scipy(As), CSR.from_scipy(Bs), alpha=alpha,
                         alg=alg, chunk_fraction=0.3, impl=impl)
        got = pt.spgemm(_port(As), _port(Bs), alpha=alpha, alg=alg,
                        chunk_fraction=0.3, impl=impl)
        assert got.data.numpy().dtype == np.dtype(dt) == want.dtype
        _same_structure(got, want)
        if impl == "esc" and dt == np.float64:
            assert_bitwise(got.data, np.asarray(want.data))  # the tree
        else:
            _close(got.data, want.data, _tol(dt))
        ref = alpha * (As @ Bs).toarray()
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(got.toarray().numpy(), ref,
                                   atol=_tol(dt) * scale)


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_spgemm_dtype_deterministic(dt):
    with jax.enable_x64(True):
        As, Bs = _make_pair(dt, seed=3)
        a, b = _port(As), _port(Bs)
        c1 = pt.spgemm(a, b, alg=2, impl="esc")
        c2 = pt.spgemm(a, b, alg=2, impl="esc")
        assert_bitwise(c1.data, c2.data)
        want = st.spgemm(CSR.from_scipy(As), CSR.from_scipy(Bs), alg=2,
                         impl="esc")
        _same_structure(c1, want)
        if dt in (np.float32, np.float64):
            assert_bitwise(c1.data, np.asarray(want.data))
        else:
            _close(c1.data, want.data, _tol(dt))


def test_spgemm_mixed_dtypes_promote():
    with jax.enable_x64(True):
        As, _ = _make_pair(np.float32)
        _, Bs = _make_pair(np.float64)
        got = pt.spgemm(_port(As), _port(Bs), alg=2)
        want = st.spgemm(CSR.from_scipy(As), CSR.from_scipy(Bs), alg=2)
        assert got.dtype == torch.float64 and want.dtype == jnp.float64
        _same_structure(got, want)
        _close(got.data, want.data, 1e-12)
        ref = (As.astype(np.float64) @ Bs).toarray()
        np.testing.assert_allclose(got.toarray().numpy(), ref, rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("dt", [np.float64, np.complex128])
def test_spmv_spmm_wide_dtypes(dt):
    with jax.enable_x64(True):
        As, _ = _make_pair(dt)
        rng = np.random.default_rng(4)
        x = rng.standard_normal(36).astype(dt)
        X = rng.standard_normal((36, 5)).astype(dt)
        A = CSR.from_scipy(As)
        a = _port(As)
        y, Z = pt.spmv(a, x), pt.spmm(a, X)
        assert y.numpy().dtype == np.dtype(dt) == Z.numpy().dtype
        _close(y, st.spmv(A, jnp.asarray(x)), 1e-12)
        _close(Z, st.spmm(A, jnp.asarray(X)), 1e-12)
        np.testing.assert_allclose(y.numpy(), As @ x, rtol=1e-10)
        np.testing.assert_allclose(Z.numpy(), As @ X, rtol=1e-10)


@pytest.mark.parametrize("dt", [np.float64, np.int32, np.complex64,
                                np.complex128],
                         ids=["float64", "int32", "complex64", "complex128"])
def test_spmm_bsr_routes_wide_dtypes(dt):
    """spmm(via="bsr_pallas") and via="bsr" in each dtype against JAX's
    (its Pallas kernel in interpret mode, and `_bsr_spmm`); ragged K and
    N.  JAX's kernel raises for a complex dtype, and so does the port's."""
    with jax.enable_x64(True):
        As, _ = _make_pair(np.float64 if dt == np.int32 else dt, m=40, k=36)
        rng = np.random.default_rng(5)
        if dt == np.int32:
            As.data = rng.integers(-9, 10, As.nnz).astype(dt)
            X = rng.integers(-9, 10, (36, 7)).astype(dt)
        else:
            X = rng.standard_normal((36, 7)).astype(dt)
        A = CSR.from_scipy(As).tobsr((8, 16))
        a = _port(As).tobsr((8, 16))
        for via in ("bsr_pallas", "bsr"):
            if via == "bsr_pallas" and np.iscomplexobj(X):
                for lib, mat in ((st, A), (pt, a)):
                    with pytest.raises(NotImplementedError):
                        lib.spmm(mat, X, via=via)
                continue
            got = pt.spmm(a, X, via=via, alpha=2)
            want = st.spmm(A, jnp.asarray(X), via=via, alpha=2)
            assert got.numpy().dtype == np.dtype(dt) == want.dtype
            if dt == np.int32:
                assert_bitwise(got, np.asarray(want))
            else:
                _close(got, want, _tol(dt))
        np.testing.assert_allclose(got.numpy(), 2 * (As @ X), rtol=1e-4,
                                   atol=1e-5)


def test_spgemm_empty_wide_dtype():
    with jax.enable_x64(True):
        e_a = sp.csr_matrix((8, 6), dtype=np.complex128)
        e_b = sp.csr_matrix((6, 4), dtype=np.complex128)
        want = st.spgemm(CSR.from_scipy(e_a), CSR.from_scipy(e_b), alg=2)
        got = pt.spgemm(_port(e_a), _port(e_b), alg=2)
        assert got.nnz == 0 == want.nnz and got.dtype == torch.complex128
        _same_structure(got, want)


# -- tests/test_dtypes.py (bfloat16) ----------------------------------------


def _bf16_pair(m, n, density, seed):
    """One COO of `coo_arrays` values rounded to bfloat16 (three of them
    set to explicit zeros), as a JAX CSR and the port's on the CPU."""
    row, col, data = coo_arrays(m, n, density, seed)
    data[:3] = 0.0
    ref = st.COO((jnp.asarray(data).astype(jnp.bfloat16), (row, col)),
                 shape=(m, n)).tocsr()
    got = pt.COO((torch.from_numpy(data).to(torch.bfloat16), (row, col)),
                 shape=(m, n), device="cpu").tocsr()
    return ref, got


@pytest.fixture
def pair16():
    return _bf16_pair(48, 40, 0.2, 0), _bf16_pair(40, 36, 0.2, 1)


def bf16_ulps(got, want) -> int:
    """Largest distance in bf16 ulps between two bfloat16 arrays."""
    def ordered(bits):
        bits = bits.astype(np.int32)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    g = ordered(as_bits(got))
    w = ordered(np.asarray(want).view(np.uint16))
    return int(np.abs(g - w).max(initial=0))


@pytest.mark.parametrize("alg", [1, 2, 3])
def test_spgemm_bf16(pair16, alg):
    (a_ref, a), (b_ref, b) = pair16
    want = st.spgemm(a_ref, b_ref, alg=alg, chunk_fraction=0.3)
    got = pt.spgemm(a, b, alg=alg, chunk_fraction=0.3)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _same_structure(got, want)
    assert bf16_ulps(got.data, want.data) <= 2
    ref = (a.to_scipy() @ b.to_scipy()).toarray()
    np.testing.assert_allclose(got.toarray().float().numpy(), ref,
                               rtol=0.05, atol=0.05)
    # explicit zeros stay structural: the pattern product's nnz
    As, Bs = a.to_scipy(), b.to_scipy()
    Ap = sp.csr_matrix((np.ones(As.nnz), As.indices, As.indptr), As.shape)
    Bp = sp.csr_matrix((np.ones(Bs.nnz), Bs.indices, Bs.indptr), Bs.shape)
    assert got.nnz == (Ap @ Bp).nnz


def test_spgemm_bf16_algs_agree_structurally(pair16):
    (_, a), (_, b) = pair16
    c1 = pt.spgemm(a, b, alg=1)
    c2 = pt.spgemm(a, b, alg=2)
    assert_bitwise(c1.indptr, c2.indptr)
    assert_bitwise(c1.indices, c2.indices)


def test_spmv_spmm_bf16(pair16):
    (a_ref, a), _ = pair16
    y = pt.spmv(a, torch.ones(40, dtype=torch.bfloat16))
    Z = pt.spmm(a, torch.ones((40, 8), dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and Z.dtype == torch.bfloat16
    assert bf16_ulps(y, st.spmv(a_ref, jnp.ones(40, jnp.bfloat16))) <= 2
    assert bf16_ulps(Z, st.spmm(a_ref, jnp.ones((40, 8), jnp.bfloat16))) <= 2
    ref = a.to_scipy() @ np.ones(40, np.float32)
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=0.05, atol=0.05)


def test_spmm_bsr_routes_bf16(pair16):
    """spmm(via="bsr_pallas") and via="bsr" in bfloat16 against JAX's,
    within 2 bf16 ulps."""
    (a_ref, a), _ = pair16
    X = np.random.default_rng(6).random((40, 9), dtype=np.float32)
    xb = jnp.asarray(X).astype(jnp.bfloat16)
    for via in ("bsr_pallas", "bsr"):
        got = pt.spmm(a.tobsr((8, 8)), torch.from_numpy(X).to(
            torch.bfloat16), via=via)
        want = st.spmm(a_ref.tobsr((8, 8)), xb, via=via)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert bf16_ulps(got, want) <= 2


def test_container_roundtrip_bf16(pair16):
    (a_ref, a), _ = pair16
    for fmt in ("coo", "csc", "csr"):
        got = a.asformat(fmt)
        assert got.dtype == torch.bfloat16
        assert_same(got, a_ref.asformat(fmt))
        assert_bitwise(got.toarray(), a.toarray())


def test_random_bf16():
    a = pt.random(30, 20, 0.3, format="csr", dtype=torch.bfloat16, seed=3,
                  device="cpu")
    a32 = pt.random(30, 20, 0.3, format="csr", seed=3, device="cpu")
    assert a.dtype == torch.bfloat16
    assert_bitwise(a.indices, a32.indices)
    assert_bitwise(a.data, a32.data.to(torch.bfloat16))


# -- the kernels' plain versions and CPU emulations at every width ---------

WIDTH_DTYPES = [torch.bfloat16, torch.float32, torch.float64,
                torch.complex64, torch.complex128]


def _values(dtype, n, seed):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal(2 * n))
    if dtype.is_complex:
        return torch.complex(v[:n], v[n:]).to(dtype)
    return v[:n].to(dtype)


@pytest.mark.parametrize("dtype", WIDTH_DTYPES, ids=str)
def test_densify_and_extract_move_bytes(dtype):
    """densify_onehot and extract_roll at every width: bitwise `toarray()`
    and the kept cells, also through the CPU emulations of the kernels'
    windows (16 KB of values: 4096 cells of up to 4 bytes, 2048 of 8,
    1024 of 16) and tiles."""
    m, k = 37, 301
    indptr, indices, data = csr_arrays(m, k, 0.2, seed=5, zeros=2,
                                       empty_rows=(4,))
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    vals = _values(dtype, data.size, 6)
    vals[:2] = -0.0  # a stored -0.0 moves as it is
    dense, pat = densify_onehot(ip, ix, vals, m, k)
    want = pt.CSR.from_parts(ip, ix, vals, (m, k), canonical=True).toarray()
    assert_bitwise(dense, want)
    window = 4096 * 4 // max(4, dtype.itemsize)
    for w in (window, 64):
        win, win_pat = densify_onehot_windows(ip, ix, vals, m, k, w)
        assert_bitwise(win, dense)
        assert_bitwise(win_pat, pat)
    mask = pat != 0
    nnz = int(mask.sum())
    for cap in (nnz, nnz + 7, nnz - 5):
        got = extract_roll(dense, mask, cap)
        for tile in (256, 4096):
            for x, y in zip(extract_roll_tiles(dense, mask, cap, tile, 16),
                            got):
                assert_bitwise(x, y)
    _, col, out = extract_roll(dense, mask, nnz)
    assert_bitwise(col, ix)
    assert_bitwise(out, vals)


# -- precision modes --------------------------------------------------------

MODES = ["highest", "high", "default"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", ["alg1", "fixed", "alg2", "alg3", "plan"])
def test_precision_modes_against_jax(mode, path):
    """Each mode against JAX's output in the same mode, at the tolerance of
    "highest" (structure bitwise, values within 1e-6 + 1e-6 max|C|)."""
    a_ref, a = pair(96, 80, 0.1, seed=31)
    b_ref, b = pair(80, 72, 0.1, seed=32)
    if path == "plan":
        want = st.spgemm_plan(a_ref, b_ref, precision=mode)(
            a_ref.data, b_ref.data, 1.5)
        got = pt.spgemm_plan(a, b, precision=mode)(a.data, b.data, 1.5)
    elif path == "fixed":
        want, _ = st.spgemm_fixed(a_ref, b_ref, 1.5, precision=mode)
        got, _ = pt.spgemm_fixed(a, b, 1.5, precision=mode)
    else:
        alg = {"alg1": 1, "alg2": 2, "alg3": 3}[path]
        want = st.spgemm(a_ref, b_ref, 1.5, alg=alg, precision=mode,
                         impl="dense")
        got = pt.spgemm(a, b, 1.5, alg=alg, precision=mode, impl="dense")
    _same_structure(got, want)
    w = np.asarray(want.data)
    np.testing.assert_allclose(got.data.numpy(), w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())


def test_unknown_precision_raises():
    a_ref, a = pair(16, 16, 0.3, seed=1)
    with pytest.raises(KeyError):
        st.spgemm(a_ref, a_ref, alg=1, precision="tf32")
    for call in (lambda: pt.spgemm(a, a, alg=1, precision="tf32"),
                 lambda: pt.spgemm_fixed(a, a, precision="tf32"),
                 lambda: pt.spgemm_plan(a, a, precision="tf32")):
        with pytest.raises(ValueError, match="precision"):
            call()


GATE = 1e-6


def _gate_ratio(c32: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """max |c - C64| / (1e-6 |C64| + 1e-6 max|C64|): <= 1 passes the gate
    of "highest"."""
    ref = a.double() @ b.double()
    tol = GATE * ref.abs() + GATE * ref.abs().max()
    return float(((c32.double() - ref).abs() / tol).max())


def _dense_operands(kind):
    """Dense A (512 x 384) and B (384 x 448) of a SpGEMM cell's kind: U[0,1)
    values at density 0.1, N(0,1) values at 0.3, or magnitudes spread over
    10^4 with random signs."""
    rng = np.random.default_rng({"uniform": 1, "normal": 2, "spread": 3}[kind])
    out = []
    for shape in ((512, 384), (384, 448)):
        if kind == "uniform":
            v = rng.random(shape) * (rng.random(shape) < 0.1)
        elif kind == "normal":
            v = rng.standard_normal(shape) * (rng.random(shape) < 0.3)
        else:
            v = (10.0 ** rng.uniform(-2, 2, shape)
                 * rng.choice([-1.0, 1.0], shape) * (rng.random(shape) < 0.1))
        out.append(torch.from_numpy(v.astype(np.float32)))
    return out


@pytest.mark.parametrize("kind", ["uniform", "normal", "spread"])
def test_high_split_within_the_gate(kind):
    """The 3xTF32 arithmetic (TF32 operands, exact products, float32 sums)
    within the 1e-6 gate of the float64 product; one TF32 pass misses it."""
    a, b = _dense_operands(kind)
    big_a, small_a = sg.tf32_split(a)
    assert not bool(((big_a.view(torch.int32) | small_a.view(torch.int32))
                     & 0x1FFF).any())  # both TF32 values
    assert _gate_ratio(sg.tf32x3_matmul(a, b), a, b) <= 1.0
    one_pass = torch.matmul(sg._tf32(a), sg._tf32(b))
    assert _gate_ratio(one_pass, a, b) > 10.0


def test_matmul_modes_restore_the_global_setting():
    mm = torch.backends.cuda.matmul
    before = mm.fp32_precision
    for mode in ("tf32", "ieee"):
        with sg._fp32_matmul(mode):
            assert mm.fp32_precision == mode
        assert mm.fp32_precision == before
