"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor spmm_tpu, so it runs where the port runs; from the
repository root on a machine with a card (the repo's conftest imports jax,
hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The plain versions and the CPU path are held against the JAX package by
tests/test_torch_kernels.py and tests/test_torch_spgemm.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot, densify_onehot_plain)
from spmm_tpu_torch.ops.kernels.extract_roll import (  # noqa: E402
    extract_roll, extract_roll_plain)
from torch_port_helpers import (assert_bitwise, csr_arrays,  # noqa: E402
                                masked_dense)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _on(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,density,kw", [
    (64, 128, 0.1, {}),
    (100, 300, 0.05, {}),
    (33, 45, 0.3, {"zeros": 3, "empty_rows": (0, 7, 32)}),
    (1, 5000, 0.2, {}),       # one long row: lanes stride many entries
    (3000, 7, 0.5, {}),       # many short rows, k not a multiple of 32
])
@pytest.mark.parametrize("with_pattern", [True, False])
def test_densify_kernel_bitwise_vs_plain(dev, m, k, density, kw,
                                         with_pattern):
    arrays = _on(dev, *csr_arrays(m, k, density, seed=m + k, **kw))
    before = _build.LAUNCHES["densify_onehot"]
    got = densify_onehot(*arrays, m, k, with_pattern=with_pattern)
    assert _build.LAUNCHES["densify_onehot"] == before + 1
    want = densify_onehot_plain(*arrays, m, k, with_pattern=with_pattern)
    torch.cuda.synchronize()
    assert_bitwise(got[0], want[0])
    if with_pattern:
        assert_bitwise(got[1], want[1])
    else:
        assert got[1] is None


@pytest.mark.gpu
def test_densify_empty_launches_nothing(dev):
    indptr, indices, data = _on(dev, *csr_arrays(6, 9, 0.0, seed=1))
    before = dict(_build.LAUNCHES)
    val, pat = densify_onehot(indptr, indices, data, 6, 9)
    assert _build.LAUNCHES == before
    assert not val.any() and not pat.any() and val.shape == (6, 9)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,g", [
    (64, 256, 33),
    (16, 128, 0),
    (24, 100, 1900),
    (3, 1000, 2500),          # rows span several 256-cell chunks
    (500, 7, 100),            # rows narrower than a warp
])
def test_extract_kernel_bitwise_vs_plain(dev, m, n, g):
    c, mask, nnz = masked_dense(m, n, g, seed=g + 5)
    c, mask = _on(dev, c, mask)
    for cap in (nnz, nnz + 5, max(nnz - 5, 0), 0):
        before = _build.LAUNCHES["extract_roll"]
        got = extract_roll(c, mask, cap)
        assert _build.LAUNCHES["extract_roll"] == before + 1
        want = extract_roll_plain(c, mask, cap)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert_bitwise(x, y)


@pytest.mark.gpu
def test_extract_zero_rows_launches_nothing(dev):
    c = torch.zeros((0, 5), device=dev)
    before = dict(_build.LAUNCHES)
    indptr, col, vals = extract_roll(c, c != 0, 0)
    assert _build.LAUNCHES == before
    assert indptr.tolist() == [0] and col.numel() == vals.numel() == 0


@pytest.mark.gpu
def test_wrappers_reject_mixed_devices(dev):
    indptr, indices, data = _on(dev, *csr_arrays(6, 9, 0.3, seed=2))
    with pytest.raises(ValueError, match="device|on"):
        densify_onehot(indptr.cpu(), indices, data, 6, 9)
    c = torch.ones((4, 4), device=dev)
    with pytest.raises(ValueError, match="mask"):
        extract_roll(c, (c > 0).cpu(), 16)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,density", [
    (40, 72, 56, 0.2),
    (256, 256, 256, 0.1),
    (32, 32, 32, 0.9),        # full output
])
def test_spgemm_on_card_matches_cpu_path(dev, m, k, n, density):
    a = pt.random(m, k, density, seed=1)
    b = pt.random(k, n, density, seed=2)
    want = pt.spgemm(a, b)
    before = dict(_build.LAUNCHES)
    got = pt.spgemm(a.to(dev), b.to(dev))
    assert got.device.type == "cuda" and got.has_canonical_format
    assert _build.LAUNCHES["densify_onehot"] == before["densify_onehot"] + 2
    assert _build.LAUNCHES["extract_roll"] == before["extract_roll"] + 1
    assert_bitwise(got.indptr, want.indptr)
    assert_bitwise(got.indices, want.indices)
    w = want.data.numpy()
    np.testing.assert_allclose(got.data.cpu().numpy(), w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())
    again = pt.spgemm(a.to(dev), b.to(dev))
    assert_bitwise(again.data, got.data)


@pytest.mark.gpu
def test_spgemm_fixed_on_card_pads(dev):
    a = pt.random(40, 72, 0.2, seed=3, device=dev)
    b = pt.random(72, 56, 0.2, seed=4, device=dev)
    exact = pt.spgemm(a, b)
    got, nnz = pt.spgemm_fixed(a, b, cap=exact.nnz + 9)
    assert int(nnz) == exact.nnz and got.nnz == exact.nnz + 9
    assert_bitwise(got.indptr, exact.indptr)
    assert_bitwise(got.data[:exact.nnz], exact.data)
    assert not got.data[exact.nnz:].any()
    with pytest.raises(ValueError, match="capacity"):
        pt.spgemm_fixed(a, b, cap=exact.nnz - 1)
