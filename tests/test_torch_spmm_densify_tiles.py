"""CPU emulations of the work split of the port's one-launch SpMM and
densify kernels, against their plain versions and the JAX package.

`csrc/spmm_routed.cu` gives each row up to `cut`, and each chunk of a
longer row taken in the plan's `chunk_order`, to a group of G lanes of VEC
columns each; the group that completes a long row's counter adds the row's
partials in chunk order.  `spmv_routed.spmm_routed_schedule` repeats that
split on the CPU for any (G, VEC), with the items finishing in a random
order, and checks that every cell is written once and every counter is
reset.  It is held against `spmm_routed_plain` and JAX's `spmm_routed` in
interpret mode at the tolerance of tests/test_torch_spmv.py's SpMM tests
(rtol 1e-4, atol 1e-5: the sums run in another order than JAX's), with
`cut` and `ch` lowered so that small matrices reach the long rows.

`csrc/densify.cu::densify_rows` writes the flat dense output window by
window; `densify_onehot.densify_onehot_windows` repeats that at window
sizes far below the kernel's 4096 (8 and 64) so that rows cross many
windows and windows hold many rows.  It is held bitwise against the plain
version and JAX's `densify_onehot` in interpret mode (values are moved,
never computed).  Inputs are made with numpy from a seed and handed to
both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import spmm_tpu as st  # noqa: E402,F401  (CPU config via conftest)
from spmm_tpu.models import matrices as jax_models  # noqa: E402
from spmm_tpu.ops.kernels import spmv_routed as jax_routed  # noqa: E402
from spmm_tpu.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot as jax_densify, densify_onehot_plan)
from spmm_tpu_torch.ops.kernels import densify_onehot as kd  # noqa: E402
from spmm_tpu_torch.ops.kernels import spmv_routed as kr  # noqa: E402
from torch_port_helpers import assert_bitwise, csr_arrays  # noqa: E402


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# spmm_routed: the items, chunk_order, the closing group
# ---------------------------------------------------------------------------

def _spmm_arrays(name):
    """(indptr, indices, data, m, n): a uniform matrix, one with empty
    rows and explicit zeros, and a power-law one whose long rows cross
    many chunks at cut 8, ch 16."""
    if name == "powerlaw":
        a = jax_models.power_law_rows(256, 300, 8, seed=3)
        return (np.array(a.indptr), np.array(a.indices), np.array(a.data),
                *a.shape)
    if name == "uniform":
        return (*csr_arrays(120, 90, 0.12, seed=1), 120, 90)
    return (*csr_arrays(80, 70, 0.2, seed=2, zeros=5,
                        empty_rows=(0, 9, 40, 79)), 80, 70)


# (G, VEC, k): every group the kernel takes, k within one column block
# and across several (up to six at 8 lanes of one column); VEC = 4 only
# where k % 4 == 0, as in the kernel
GROUPS = [(8, 1, 1), (8, 1, 45), (16, 1, 13), (32, 1, 33), (32, 1, 45),
          (8, 4, 12), (8, 4, 64), (16, 4, 64), (32, 4, 12), (32, 4, 128)]


@pytest.mark.parametrize("sell", [True, False])
@pytest.mark.parametrize("group,vec,k", GROUPS)
@pytest.mark.parametrize("name", ["uniform", "zeros_and_empty", "powerlaw"])
def test_spmm_schedule_matches_plain_and_jax(name, group, vec, k, sell):
    indptr, indices, data, m, n = _spmm_arrays(name)
    plan = kr.spmv_routed_plan(indptr, indices, data, m, n, cut=8, ch=16,
                               sell=sell, device="cpu")
    assert plan.long_rows.numel() > 0
    x = np.random.default_rng(m + k).standard_normal((n, k)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    want = kr.spmm_routed_plain(xt, plan)
    for seed in range(2):  # two finishing orders
        got = kr.spmm_routed_schedule(xt, plan, group, vec, seed=seed)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert not plan.counters.any()  # the emulation works on a copy
    jp = jax_routed.spmv_routed_plan(indptr, indices, data, m, n)
    if jp is not None:  # None: skew the TPU plan rejects
        jax = np.asarray(jax_routed.spmm_routed(jnp.asarray(x), jp,
                                                interpret=True))
        np.testing.assert_allclose(got.numpy(), jax, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["uniform", "zeros_and_empty", "powerlaw"])
@pytest.mark.parametrize("cut,ch", [(8, 16), (4, 3), (2, 1)])
def test_chunk_order_is_sorted_by_first_column(name, cut, ch):
    """A permutation of the chunks, by (first column, chunk id)."""
    indptr, indices, data, m, n = _spmm_arrays(name)
    plan = kr.spmv_routed_plan(indptr, indices, data, m, n, cut=cut, ch=ch,
                               device="cpu")
    order = plan.chunk_order.numpy()
    nchunks = plan.chunk_start.numel()
    assert order.dtype == np.int32 and order.size == nchunks
    assert np.array_equal(np.sort(order), np.arange(nchunks))
    first = indices[plan.chunk_start.numpy()[order]].astype(np.int64)
    key = first * nchunks + order
    assert (np.diff(key) > 0).all()


@pytest.mark.parametrize("k,vec4,want", [
    (1, False, (8, 1)), (8, False, (8, 1)), (9, False, (16, 1)),
    (33, False, (32, 1)), (45, False, (32, 1)), (64, False, (32, 1)),
    (4, True, (8, 4)), (32, True, (8, 4)), (36, True, (16, 4)),
    (64, True, (16, 4)), (68, True, (32, 4)), (128, True, (32, 4)),
    (512, True, (32, 4))])
def test_spmm_group_choice(k, vec4, want):
    """The fewest of 8, 16 and 32 lanes that reach k (32 past that), 4
    columns a lane where the kernel can load 16 bytes."""
    assert kr.spmm_groups(k, vec4) == want


def test_spmm_schedule_of_a_row_over_many_chunks():
    """One row of 3000 entries in 188 chunks of 16 between empty rows, at
    k = 45 (six column blocks of 8 lanes): the row closes once, by the
    item that completes 188 * 6 counts."""
    n = 3000
    indptr = np.array([0, 0, n, n], np.int32)
    indices = np.arange(n, dtype=np.int32)
    data = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    plan = kr.spmv_routed_plan(indptr, indices, data, 3, n, cut=8, ch=16,
                               device="cpu")
    assert plan.chunk_start.numel() == 188
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n, 45)).astype(np.float32))
    got = kr.spmm_routed_schedule(x, plan, 8, 1, seed=3)
    np.testing.assert_allclose(got.numpy(),
                               kr.spmm_routed_plain(x, plan).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not got[0].any() and not got[2].any()


# ---------------------------------------------------------------------------
# densify_onehot: the window fill
# ---------------------------------------------------------------------------

# (m, k, density, extra arguments of csr_arrays): explicit zeros, empty
# rows (first, middle, last), k = 1, 3, 4095 and 4097, most with m*k not a
# multiple of the window
DENSIFY_CASES = [(40, 45, 0.3, {"zeros": 3, "empty_rows": (0, 7, 8, 39)}),
                 (64, 128, 0.1, {}), (33, 136, 0.2, {"zeros": 2}),
                 (500, 1, 0.5, {"zeros": 4}), (200, 3, 0.4, {}),
                 (3, 4095, 0.05, {"empty_rows": (1,)}),
                 (3, 4097, 0.05, {"zeros": 2}), (1, 9000, 0.2, {})]


def _jax_densify(indptr, indices, data, m, k, with_pattern=True):
    plan = densify_onehot_plan(indptr, m, k, ch=256)
    assert plan is not None
    return jax_densify(jnp.asarray(indptr), jnp.asarray(indices),
                       jnp.asarray(data), m, k, plan, interpret=True,
                       with_pattern=with_pattern)


@pytest.mark.parametrize("window", [8, 64, 4096])
@pytest.mark.parametrize("m,k,density,kw", DENSIFY_CASES)
def test_densify_windows_bitwise_plain_and_jax(window, m, k, density, kw):
    indptr, indices, data = csr_arrays(m, k, density, seed=m + k, **kw)
    args = _t(indptr, indices, data)
    got = kd.densify_onehot_windows(*args, m, k, window)
    want = kd.densify_onehot_plain(*args, m, k)
    for x, y in zip(got, want):
        assert_bitwise(x, y)
    for x, y in zip(got, _jax_densify(indptr, indices, data, m, k)):
        assert_bitwise(x, y)
    value_only = kd.densify_onehot_windows(*args, m, k, window,
                                           with_pattern=False)
    assert value_only[1] is None
    assert_bitwise(value_only[0], want[0])
    assert_bitwise(value_only[0], _jax_densify(indptr, indices, data, m, k,
                                               with_pattern=False)[0])
    # a stored zero is 0.0 in the values and 1 in the pattern
    assert float(got[1].float().sum()) == data.size
