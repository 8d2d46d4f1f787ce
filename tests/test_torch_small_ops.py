"""The port's `sddmm` and availability table against the JAX package's:
twins of tests/test_ops.py::test_sddmm_parity and
tests/test_fixed_and_availability.py::test_availability_table.

Each S is made once with numpy and handed to both packages (a CSR, CSC or
COO, with and without duplicate entries), as are A and B.  The result's
structure must be bitwise JAX's, its values within
1e-6 * |alpha| * |s| * (|A||B|)_ij of JAX's: the dot products are added in
another order than XLA's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.ops import availability as javail  # noqa: E402
from spmm_tpu_torch.ops import (check_availability,  # noqa: E402
                                has_fast_path)
from torch_port_helpers import (STRUCTURE, assert_bitwise,  # noqa: E402
                                coo_arrays)


def _s_pair(m, n, density, seed, fmt, duplicates):
    """The same S as a JAX and a port matrix in `fmt`; with `duplicates`,
    every third entry stored twice (a second value of its own)."""
    row, col, data = coo_arrays(m, n, density, seed)
    if duplicates:
        rng = np.random.default_rng(seed + 1)
        row = np.concatenate([row, row[::3]])
        col = np.concatenate([col, col[::3]])
        data = np.concatenate(
            [data, rng.random(row.size - data.size, dtype=np.float32)])
    ref = st.COO((data, (row, col)), shape=(m, n)).asformat(fmt)
    got = pt.COO((data, (row, col)), shape=(m, n),
                 device="cpu").asformat(fmt)
    return ref, got


def _dense_ab(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 1.5, -0.75])
@pytest.mark.parametrize("m,n,k,density", [(50, 60, 16, 0.1),
                                           (33, 17, 5, 0.4),
                                           (8, 90, 1, 0.2)])
def test_sddmm_matches_jax(fmt, duplicates, alpha, m, n, k, density):
    s_ref, s = _s_pair(m, n, density, m + n, fmt, duplicates)
    a, b = _dense_ab(m, n, k, k)
    want = st.sddmm(s_ref, jnp.asarray(a), jnp.asarray(b), alpha=alpha)
    got = pt.sddmm(s, torch.from_numpy(a), torch.from_numpy(b), alpha=alpha)
    assert got.format == want.format == fmt
    assert tuple(got.shape) == tuple(want.shape)
    for name in STRUCTURE[fmt]:
        assert_bitwise(getattr(got, name), np.asarray(getattr(want, name)))
    # the gate per entry, carried through the same structure: |alpha| |s|
    # (|A||B|)_ij, summed where duplicates are
    s_abs = pt.COO(s.tocoo(), device="cpu")._with_data(
        s.tocoo().data.abs().double()).asformat(fmt)
    gate = pt.sddmm(s_abs, torch.from_numpy(np.abs(a)).double(),
                    torch.from_numpy(np.abs(b)).double(), alpha=abs(alpha))
    err = np.abs(got.data.double().numpy()
                 - np.asarray(want.data, np.float64))
    assert (err <= 1e-6 * gate.data.numpy() + 1e-30).all(), err.max()


def test_sddmm_dense_reference():
    """The port's values against the float64 product, as the JAX test
    holds JAX's against scipy's."""
    s_ref, s = _s_pair(50, 60, 0.1, 0, "csr", False)
    a, b = _dense_ab(50, 60, 16, 1)
    got = pt.sddmm(s, a, b, alpha=1.5)
    want = s_ref.to_scipy().multiply(1.5 * (a.astype(np.float64) @ b))
    np.testing.assert_allclose(got.toarray().numpy(), want.toarray(),
                               rtol=1e-5, atol=1e-6)


def test_sddmm_empty_sampling_matrix():
    s_ref, s = _s_pair(20, 30, 0.0, 3, "csr", False)
    a, b = _dense_ab(20, 30, 4, 2)
    got = pt.sddmm(s, a, b)
    want = st.sddmm(s_ref, jnp.asarray(a), jnp.asarray(b))
    assert got.nnz == want.nnz == 0
    assert_bitwise(got.indptr, np.asarray(want.indptr))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sddmm_errors(pkg):
    s_ref, s = _s_pair(6, 7, 0.3, 1, "csr", False)
    a, b = _dense_ab(6, 7, 3, 0)
    if pkg == "jax":
        fn, s, conv = st.sddmm, s_ref, jnp.asarray
    else:
        fn, conv = pt.sddmm, torch.from_numpy
    with pytest.raises(TypeError, match="sparse sampling matrix"):
        fn(conv(np.ones((6, 7), np.float32)), conv(a), conv(b))
    with pytest.raises(ValueError, match="dimension mismatch"):
        fn(s, conv(a[:5]), conv(b))
    with pytest.raises(ValueError, match="dimension mismatch"):
        fn(s, conv(a), conv(b[:, :6]))
    with pytest.raises(ValueError, match="dimension mismatch"):
        fn(s, conv(a[:, :2]), conv(b))


def test_sddmm_dense_operand_on_another_device():
    _, s = _s_pair(6, 7, 0.3, 1, "csr", False)
    a, b = _dense_ab(6, 7, 3, 0)
    with pytest.raises(ValueError, match="sddmm"):
        pt.sddmm(s, torch.from_numpy(a).to("meta"), b)


def test_sddmm_exported():
    from spmm_tpu_torch.ops import sddmm

    assert pt.sddmm is sddmm


def test_availability_table():
    """tests/test_fixed_and_availability.py:49 on the port's device
    types (with no card here, the default is "cpu")."""
    assert check_availability("spgemm")
    assert check_availability("spmv", backend="cuda")
    assert not check_availability("csrmv")
    assert has_fast_path("spgemm", backend="cuda")
    assert not has_fast_path("csrsort", backend="cuda")
    assert not has_fast_path("spgemm", backend="cpu")
    with pytest.raises(KeyError):
        check_availability("nonsense")
    with pytest.raises(KeyError):
        has_fast_path("nonsense")


@pytest.mark.parametrize("name", sorted(javail._AVAILABILITY))
def test_availability_follows_jax(name):
    """Available on "cpu" and "cuda" where JAX's is on cpu/tpu/gpu (and
    `bsr_spmm_pallas`, which JAX runs on cpu and tpu); the fast path on
    "cuda" where JAX's is on "tpu"; nowhere for csrmv and csrmm2."""
    available = javail.check_availability(name, backend="tpu")
    assert check_availability(name, backend="cpu") == available
    assert check_availability(name, backend="cuda") == available
    assert check_availability(name, backend="tpu") is False
    assert has_fast_path(name, backend="cuda") == javail.has_fast_path(
        name, backend="tpu")
    assert has_fast_path(name, backend="cpu") is False
