"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version bitwise against the Pallas kernel in interpret mode, at the
JAX package's own test shapes.  The CUDA kernels themselves are held
against the plain versions by `tests/test_torch_cuda.py` and by
`chip_smoke.py`, on the card.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import spmm_tpu as st  # noqa: E402,F401  (CPU config via conftest)
from spmm_tpu.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot as jax_densify, densify_onehot_plan)
from spmm_tpu.ops.kernels.extract_roll import (  # noqa: E402
    extract_roll as jax_extract)
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot, densify_onehot_plain)
from spmm_tpu_torch.ops.kernels.extract_roll import (  # noqa: E402
    extract_roll, extract_roll_plain)
from torch_port_helpers import (assert_bitwise, csr_arrays,  # noqa: E402
                                masked_dense)

jax_sg = importlib.import_module("spmm_tpu.ops.spgemm")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax_densify(indptr, indices, data, m, k):
    plan = densify_onehot_plan(indptr, m, k, ch=256)
    assert plan is not None
    return jax_densify(jnp.asarray(indptr), jnp.asarray(indices),
                       jnp.asarray(data), m, k, plan, interpret=True)


# ---------------------------------------------------------------------------
# densify
# ---------------------------------------------------------------------------

DENSIFY_CASES = [
    # the shapes of tests/test_densify_onehot.py
    dict(m=64, k=128, density=0.1, seed=0),
    dict(m=100, k=300, density=0.05, seed=1),
    dict(m=256, k=256, density=0.3, seed=2),
    dict(m=8, k=1024, density=0.5, seed=3),
    dict(m=33, k=136, density=0.2, seed=4),
    # explicit stored zeros, and empty rows (first, middle, last)
    dict(m=48, k=80, density=0.2, seed=5, zeros=4),
    dict(m=40, k=45, density=0.3, seed=6, zeros=2, empty_rows=(0, 7, 8, 39)),
]


@pytest.mark.parametrize("case", DENSIFY_CASES,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_densify_plain_bitwise_vs_pallas(case):
    case = dict(case)
    m, k = case.pop("m"), case.pop("k")
    arrays = csr_arrays(m, k, case.pop("density"), case.pop("seed"), **case)
    jv, jp = _jax_densify(*arrays, m, k)
    tv, tp = densify_onehot_plain(*_t(*arrays), m, k)
    assert tv.dtype == torch.float32 and tp.dtype == torch.bfloat16
    assert_bitwise(tv, jv)
    assert_bitwise(tp, jp)


def test_densify_explicit_zero_pattern():
    # the case of tests/test_densify_onehot.py: a stored zero appears in
    # the pattern but not in the values
    indptr = np.array([0, 2, 3], np.int32)
    indices = np.array([1, 40, 7], np.int32)
    data = np.array([0.0, 2.5, -1.0], np.float32)
    jv, jp = _jax_densify(indptr, indices, data, 2, 64)
    tv, tp = densify_onehot_plain(*_t(indptr, indices, data), 2, 64)
    assert_bitwise(tv, jv)
    assert_bitwise(tp, jp)
    assert float(tv[0, 1]) == 0.0 and float(tp[0, 1]) == 1.0
    assert float(tp.float().sum()) == 3.0


def test_densify_value_only_mode():
    arrays = csr_arrays(50, 70, 0.2, seed=8)
    v1, p1 = densify_onehot_plain(*_t(*arrays), 50, 70)
    v2, p2 = densify_onehot_plain(*_t(*arrays), 50, 70, with_pattern=False)
    assert p1 is not None and p2 is None
    assert_bitwise(v2, v1)


def test_densify_wrapper_on_cpu_is_plain_and_counts_nothing():
    arrays = _t(*csr_arrays(30, 40, 0.2, seed=9))
    before = dict(_build.LAUNCHES)
    got = densify_onehot(*arrays, 30, 40)
    want = densify_onehot_plain(*arrays, 30, 40)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    assert _build.LAUNCHES == before


def test_densify_wrapper_checks_inputs():
    indptr, indices, data = _t(*csr_arrays(10, 12, 0.3, seed=10))
    with pytest.raises(ValueError, match="indptr"):
        densify_onehot(indptr.long(), indices, data, 10, 12)
    # every dtype of 2, 4, 8 or 16 bytes moves; a 1-byte one is refused
    with pytest.raises(ValueError, match="data"):
        densify_onehot(indptr, indices, data.to(torch.uint8), 10, 12)
    got, _ = densify_onehot(indptr, indices, data.double(), 10, 12)
    assert_bitwise(got, densify_onehot(indptr, indices, data, 10, 12)[0]
                   .double())
    with pytest.raises(ValueError, match="rows"):
        densify_onehot(indptr, indices, data, 11, 12)


# ---------------------------------------------------------------------------
# extract
# ---------------------------------------------------------------------------


# the hole counts of tests/test_extract_roll.py
@pytest.mark.parametrize("m,n,g", [
    (32, 128, 5),
    (64, 256, 33),     # the headline-shaped hole count
    (16, 128, 0),
    (40, 128, 200),    # beyond _SHIFT_EXTRACT_MAX_HOLES
    (8, 128, 1000),
])
def test_extract_plain_bitwise_vs_pallas(m, n, g):
    c, mask, cap = masked_dense(m, n, g, seed=g + 1)
    g_pad = max(8, -(-max(g, 1) // 8) * 8)
    want = jax_extract(jnp.asarray(c), jnp.asarray(mask), cap, g_pad, m, n,
                       interpret=True)
    got = extract_roll_plain(*_t(c, mask), cap)
    for x, y in zip(got, want):
        assert_bitwise(x, y)


@pytest.mark.parametrize("m,n,g", [
    (16, 128, 0),          # full output
    (24, 100, 1900),       # most cells holes, n not a multiple of 128
    (64, 256, 12000),
])
def test_extract_plain_bitwise_vs_sort(m, n, g):
    c, mask, cap = masked_dense(m, n, g, seed=g + 3)
    want = jax_sg._extract_sort(jnp.asarray(c), jnp.asarray(mask), cap, m, n)
    got = extract_roll_plain(*_t(c, mask), cap)
    for x, y in zip(got, want):
        assert_bitwise(x, y)


def test_extract_capacity_padding_and_truncation():
    c, mask, nnz = masked_dense(20, 64, 300, seed=11)
    ip, col, val = extract_roll_plain(*_t(c, mask), nnz)
    ip2, col2, val2 = extract_roll_plain(*_t(c, mask), nnz + 7)
    assert_bitwise(ip2, ip)
    assert_bitwise(col2[:nnz], col)
    assert_bitwise(val2[:nnz], val)
    assert not col2[nnz:].any() and not val2[nnz:].any()
    ip3, col3, val3 = extract_roll_plain(*_t(c, mask), nnz - 9)
    assert_bitwise(ip3, ip)
    assert_bitwise(col3, col[:nnz - 9])
    assert_bitwise(val3, val[:nnz - 9])


def test_extract_wrapper_on_cpu_is_plain_and_counts_nothing():
    c, mask, nnz = masked_dense(12, 40, 50, seed=12)
    before = dict(_build.LAUNCHES)
    got = extract_roll(*_t(c, mask), nnz)
    want = extract_roll_plain(*_t(c, mask), nnz)
    for x, y in zip(got, want):
        assert_bitwise(x, y)
    assert _build.LAUNCHES == before


def test_extract_wrapper_checks_inputs():
    c, mask, nnz = _t(*masked_dense(6, 8, 3, seed=13)[:2]) + (45,)
    # every dtype of 2, 4, 8 or 16 bytes moves; a 1-byte one is refused
    with pytest.raises(ValueError, match="c must"):
        extract_roll(c.to(torch.uint8), mask, nnz)
    assert_bitwise(extract_roll(c.double(), mask, nnz)[2],
                   extract_roll(c, mask, nnz)[2].double())
    with pytest.raises(ValueError, match="mask"):
        extract_roll(c, mask.to(torch.uint8), nnz)
    with pytest.raises(ValueError, match="cap"):
        extract_roll(c, mask, -1)
