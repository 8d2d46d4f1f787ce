"""Randomized arithmetic parity of the port across formats and op
combinations: the twin of the 11 functions of
tests/test_arithmetic_parity.py (the breadth layer of the reference's
container suites, test_csr/test_csc/test_coo arithmetic classes).

The same numpy operands go to the JAX package and to the port (on the
CPU).  Each port result is held to the numpy / scipy reference with the
JAX test's tolerance, and to JAX's own result with the same tolerance.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402

FMT = ["csr", "csc", "coo"]


def _pair(seed, m=17, n=23, d=0.3):
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < d, rng.standard_normal((m, n)), 0.0)
    B = np.where(rng.random((m, n)) < d, rng.standard_normal((m, n)), 0.0)
    return A.astype(np.float32), B.astype(np.float32)


def _mk(arr, fmt):
    """The same dense array as a JAX and a port matrix in `fmt`."""
    return (st.CSR(arr).asformat(fmt),
            pt.CSR(arr, device="cpu").asformat(fmt))


def _np(x):
    """A port or JAX result (sparse, tensor, array, scalar) as numpy."""
    if hasattr(x, "toarray"):
        x = x.toarray()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _check(got, ref, want, rtol, atol=0.0):
    """The port's result `got` and JAX's `ref` against `want`, and the
    port's against JAX's, within rtol/atol."""
    g, r = _np(got), _np(ref)
    np.testing.assert_allclose(r, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(g, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("fmt", FMT)
def test_add_sub_sparse(fmt):
    Ad, Bd = _pair(0)
    (jA, A), (jB, B) = _mk(Ad, fmt), _mk(Bd, fmt)
    _check(A + B, jA + jB, Ad + Bd, rtol=1e-6)
    _check(A - B, jA - jB, Ad - Bd, rtol=1e-6)


@pytest.mark.parametrize("fmt", FMT)
def test_add_dense(fmt):
    Ad, Bd = _pair(1)
    jA, A = _mk(Ad, fmt)
    got = A + Bd  # dense result, scipy semantics
    assert isinstance(got, torch.Tensor)
    _check(got, jA + Bd, Ad + Bd, rtol=1e-6)
    _check(A - Bd, jA - Bd, Ad - Bd, rtol=1e-6)


@pytest.mark.parametrize("fmt", FMT)
def test_multiply_elementwise(fmt):
    Ad, Bd = _pair(2)
    (jA, A), (jB, B) = _mk(Ad, fmt), _mk(Bd, fmt)
    _check(A.multiply(B), jA.multiply(jB), Ad * Bd, rtol=1e-6)
    # dense rhs
    _check(A.multiply(Bd), jA.multiply(Bd), Ad * Bd, rtol=1e-6)


@pytest.mark.parametrize("fmt", FMT)
@pytest.mark.parametrize("axis", ["row", "col"])
def test_multiply_broadcast(fmt, axis):
    Ad, _ = _pair(3)
    jA, A = _mk(Ad, fmt)
    v = np.random.default_rng(7).standard_normal(
        (1, Ad.shape[1]) if axis == "row" else (Ad.shape[0], 1)
    ).astype(np.float32)
    _check(A.multiply(v), jA.multiply(v), Ad * v, rtol=1e-6)


def test_scalar_ops_matrix():
    Ad, _ = _pair(4)
    jA, A = _mk(Ad, "csr")
    S = sp.csr_matrix(Ad)
    for got, ref, want in [
        (A * 2.5, jA * 2.5, S * 2.5), (2.5 * A, 2.5 * jA, 2.5 * S),
        (A / 2.0, jA / 2.0, S / 2.0), (-A, -jA, -S),
        (A * np.float32(3), jA * np.float32(3), S * np.float32(3)),
    ]:
        _check(got, ref, want.toarray(), rtol=1e-6)


def test_power_matches_scipy():
    Ad, _ = _pair(5)
    jA, A = _mk(Ad, "csr")
    S = sp.csr_matrix(Ad)
    _check(A.power(2), jA.power(2), S.power(2).toarray(), rtol=1e-6)
    _check(A.power(3), jA.power(3), S.power(3).toarray(), rtol=1e-5)


@pytest.mark.parametrize("fmt", FMT)
def test_sum_mean_axes(fmt):
    Ad, _ = _pair(6)
    jA, A = _mk(Ad, fmt)
    S = sp.csr_matrix(Ad)
    _check(float(A.sum()), float(jA.sum()), S.sum(), rtol=1e-5)
    for axis in (0, 1, -1, -2):
        _check(_np(A.sum(axis=axis)).ravel(), _np(jA.sum(axis=axis)).ravel(),
               np.asarray(S.sum(axis=axis)).ravel(), rtol=1e-5)
        _check(_np(A.mean(axis=axis)).ravel(),
               _np(jA.mean(axis=axis)).ravel(),
               np.asarray(S.mean(axis=axis)).ravel(), rtol=1e-5)


@pytest.mark.parametrize("fmt", FMT)
def test_matvec_matmat_parity(fmt):
    Ad, _ = _pair(8)
    jA, A = _mk(Ad, fmt)
    x = np.random.default_rng(9).standard_normal(Ad.shape[1]).astype(
        np.float32)
    X = np.random.default_rng(10).standard_normal(
        (Ad.shape[1], 5)).astype(np.float32)
    _check(A @ x, jA @ jnp.asarray(x), Ad @ x, rtol=1e-4, atol=1e-5)
    _check(A @ X, jA @ jnp.asarray(X), Ad @ X, rtol=1e-4, atol=1e-5)


def test_transpose_conj_combo():
    rng = np.random.default_rng(11)
    Ad = (rng.standard_normal((9, 13)) + 1j * rng.standard_normal((9, 13))
          ).astype(np.complex64) * (rng.random((9, 13)) < 0.4)
    jA, A = _mk(Ad, "csr")
    assert A.dtype == torch.complex64
    _check(A.T, jA.T, Ad.T, rtol=1e-6)
    _check(A.conj(), jA.conj(), Ad.conj(), rtol=1e-6)
    _check(A.real, jA.real, Ad.real, rtol=1e-6)
    _check(A.imag, jA.imag, Ad.imag, rtol=1e-6)


@pytest.mark.parametrize("fmt", FMT)
def test_abs_sign_roundtrip(fmt):
    Ad, _ = _pair(12)
    jA, A = _mk(Ad, fmt)
    _check(abs(A), abs(jA), np.abs(Ad), rtol=1e-6)
    _check(A.sign(), jA.sign(), np.sign(Ad), rtol=1e-6)


def test_mixed_format_add():
    Ad, Bd = _pair(13)
    (jA, A), (jB, B) = _mk(Ad, "csr"), _mk(Bd, "csc")
    _check(A + B, jA + jB, Ad + Bd, rtol=1e-6)
