"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor spmm_tpu, so it runs where the port runs; from the
repository root on a machine with a card (the repo's conftest imports jax,
hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The plain versions and the CPU path are held against the JAX package by
tests/test_torch_kernels.py, tests/test_torch_spgemm.py and
tests/test_torch_spmv.py.
"""

import importlib

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
    # rows across 4096-cell windows, m*k % 4096 != 0, k % 4 != 0
    (5, 4097, 0.05, {"zeros": 2, "empty_rows": (3,)}),
    (1, 4095, 0.3, {}),
    (2, 9001, 0.1, {}),
    (700, 3, 0.4, {"empty_rows": (0, 699)}),
    (4096, 1, 0.5, {"zeros": 5}),
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


def _extract_case(name):
    """(c, mask, kept count) of an edge of the one-pass extraction: rows
    wider than a tile, many rows a tile, m = 1, all-false and all-true
    masks, ragged last tiles."""
    m, n, g = {"headline": (64, 256, 33), "full": (16, 128, 0),
               "mostly_holes": (24, 100, 1900),
               "wide_rows": (3, 70_000, 60_000),     # rows over 17 tiles
               "n1": (20_000, 1, 9_000), "n3": (7_000, 3, 5_000),
               "n15": (3_000, 15, 20_000), "n17": (3_000, 17, 1),
               "m1": (1, 9_000, 4_000),              # ragged last tile
               "narrow": (500, 7, 100)}[name] if name not in (
                   "all_false", "all_true") else (333, 129, 0)
    c, mask, nnz = masked_dense(m, n, g, seed=m + n + g)
    if name == "all_false":
        mask[:] = False
        nnz = 0
    return c, mask, nnz


EXTRACT_EDGES = ["headline", "full", "mostly_holes", "wide_rows", "n1", "n3",
                 "n15", "n17", "m1", "narrow", "all_false", "all_true"]


@pytest.fixture(params=["small tiles", "large tiles"])
def tiles(request, monkeypatch):
    """The extraction kernel at each tile size: every mask here is below
    LARGE_MASK, which "large tiles" lowers to 0."""
    from spmm_tpu_torch.ops.kernels import extract_roll as er

    if request.param == "large tiles":
        monkeypatch.setattr(er, "LARGE_MASK", 0)
    return request.param


@pytest.mark.gpu
@pytest.mark.parametrize("name", EXTRACT_EDGES)
def test_extract_kernel_bitwise_vs_plain(dev, name, tiles):
    """Every cap case (nnz, above it, below it, 0) at each edge and both
    tile sizes; bitwise the plain version and on rerun."""
    c, mask, nnz = _extract_case(name)
    c, mask = _on(dev, c, mask)
    for cap in (nnz, nnz + 5, nnz + 40_000, max(nnz - 5, 0), nnz // 3, 0):
        before = _build.LAUNCHES["extract_roll"]
        got = extract_roll(c, mask, cap)
        assert _build.LAUNCHES["extract_roll"] == before + 1
        want = extract_roll_plain(c, mask, cap)
        again = extract_roll(c, mask, cap)
        torch.cuda.synchronize()
        for x, y, z in zip(got, want, again):
            assert_bitwise(x, y)
            assert_bitwise(z, x)


@pytest.mark.gpu
def test_extract_kernel_unaligned_mask(dev, tiles):
    """A mask that starts off 16-byte alignment (a view into a larger
    buffer) takes the kernel's byte loads; the plain version agrees."""
    c, mask, nnz = masked_dense(300, 77, 5000, seed=9)
    c, mask = _on(dev, c, mask)
    buf = torch.zeros(mask.numel() + 3, dtype=torch.bool, device=dev)
    odd = buf[3:].view(mask.shape)
    odd.copy_(mask)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    for cap in (nnz, nnz + 9, nnz - 9):
        got = extract_roll(c, odd, cap)
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
    a = pt.random(m, k, density, format="csr", seed=1, device="cpu")
    b = pt.random(k, n, density, format="csr", seed=2, device="cpu")
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
    a = pt.random(40, 72, 0.2, format="csr", seed=3, device=dev)
    b = pt.random(72, 56, 0.2, format="csr", seed=4, device=dev)
    exact = pt.spgemm(a, b)
    got, nnz = pt.spgemm_fixed(a, b, cap=exact.nnz + 9)
    assert int(nnz) == exact.nnz and got.nnz == exact.nnz + 9
    assert_bitwise(got.indptr, exact.indptr)
    assert_bitwise(got.data[:exact.nnz], exact.data)
    assert not got.data[exact.nnz:].any()
    with pytest.raises(ValueError, match="capacity"):
        pt.spgemm_fixed(a, b, cap=exact.nnz - 1)


# ---------------------------------------------------------------------------
# SpMV / SpMM kernels
# ---------------------------------------------------------------------------

SPMV_EDGE = {
    "empty": (6, 9, np.zeros(7, np.int64)),
    "m1": (1, 45, None),
    "full_row": (3, 5000, np.array([0, 0, 5000, 5000])),
    "n_odd": (77, 45, None),
    "hub_and_empty": (300, 3000, None),
    # empty leading and trailing rows around rows that span many chunks
    "span_chunks": (60, 3000, None),
    # rows of 1, 2 and 4 binned pieces (4096 entries each)
    "hub_pieces": (40, 13000, None),
}


def _edge_arrays(name):
    """(indptr, indices, data) of an edge case: an empty matrix, one row,
    a full row of n entries between empty rows, n not a multiple of 32, a
    few long rows among many empty ones, rows spanning many chunks between
    empty leading and trailing rows, and rows of several binned pieces."""
    m, n, indptr = SPMV_EDGE[name]
    rng = np.random.default_rng(len(name))
    if indptr is None:
        lens = np.zeros(m, np.int64)
        if name == "hub_and_empty":
            lens[[3, 100, 299]] = [n, 1500, 700]
            lens[rng.choice(m, 40, replace=False)] += rng.integers(1, 9, 40)
            lens = np.minimum(lens, n)
        elif name == "span_chunks":
            lens[[5, 6, 30, 40]] = [2900, 1, 2000, 256]
            lens[10:25] = rng.integers(0, 40, 15)
        elif name == "hub_pieces":
            lens[[2, 3, 9, 20]] = [12295, 4096, 4097, 2049]
            lens[25:35] = rng.integers(0, 70, 10)
        else:
            lens = rng.integers(0, min(n, 30), m)
        indptr = np.concatenate([[0], np.cumsum(lens)])
    lens = np.diff(indptr)
    indices = np.concatenate(
        [np.sort(rng.choice(n, int(ln), replace=False)) for ln in lens]
        + [np.zeros(0, np.int64)])
    data = rng.standard_normal(indices.size).astype(np.float32)
    data[:3] = 0.0  # explicit stored zeros
    return (m, n, indptr.astype(np.int32), indices.astype(np.int32), data)


def _spmv_kernel(kernel, arrays, x):
    """(kernel output, plain output) of one kernel on card tensors."""
    from spmm_tpu_torch.ops.kernels import spmv_binned as kb
    from spmm_tpu_torch.ops.kernels import spmv_onehot as ko
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    m, n, indptr, indices, data = arrays
    if kernel == "binned":
        p = kb.spmv_binned_plan(indptr, indices, data, m, n)
        return kb.spmv_binned(x, p), kb.spmv_binned_plain(x, p)
    if kernel == "onehot":
        p = ko.spmv_onehot_plan(indptr, m, n, ch=256)
        return (ko.spmv_onehot(indptr, indices, data, x, m, n, p),
                ko.spmv_onehot_plain(indptr, indices, data, x, m, n, p))
    p = kr.spmv_routed_plan(indptr, indices, data, m, n, cut=32, ch=64)
    if kernel == "routed":
        return kr.spmv_routed(x, p), kr.spmv_routed_plain(x, p)
    return kr.spmm_routed(x, p), kr.spmm_routed_plain(x, p)


def _assert_rowwise(y, arrays, x, bound=1e-6):
    """|y - y64|_i <= bound * (|A| @ |x|)_i against scipy's float64."""
    import scipy.sparse as sp

    m, n, indptr, indices, data = arrays
    a = sp.csr_matrix((data.astype(np.float64), indices, indptr), (m, n))
    x64 = x.cpu().double().numpy()
    ref = a @ x64
    rowabs = abs(a) @ np.abs(x64)
    err = np.abs(y.cpu().double().numpy() - ref)
    assert (err <= bound * rowabs).all(), float((err - bound * rowabs).max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SPMV_EDGE))
@pytest.mark.parametrize("kernel,k", [("binned", None), ("onehot", None),
                                      ("routed", None), ("spmm_routed", 1),
                                      ("spmm_routed", 45)])
def test_spmv_kernels_vs_plain_on_card(dev, kernel, k, name):
    m, n, *host = _edge_arrays(name)
    arrays = (m, n, *_on(dev, *host))
    rng = np.random.default_rng(5)
    shape = (n,) if k is None else (n, k)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(dev)
    key = kernel if kernel == "spmm_routed" else f"spmv_{kernel}"
    before = _build.LAUNCHES[key]
    got, plain = _spmv_kernel(kernel, arrays, x)
    again, _ = _spmv_kernel(kernel, arrays, x)
    torch.cuda.synchronize()
    # one launch a call, an empty matrix included (its rows are written 0)
    assert _build.LAUNCHES[key] == before + 2
    assert got.shape == plain.shape and got.device == x.device
    assert_bitwise(got, again)
    _assert_rowwise(got, (m, n, *host), x)
    _assert_rowwise(plain, (m, n, *host), x)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["span_chunks", "hub_pieces", "empty",
                                  "m1"])
def test_onehot_every_chunk_size_on_card(dev, name):
    from spmm_tpu_torch.ops.kernels import spmv_onehot as ko

    m, n, *host = _edge_arrays(name)
    indptr, indices, data = _on(dev, *host)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(n).astype(
        np.float32)).to(dev)
    for ch in ko.CH_CHOICES:
        p = ko.spmv_onehot_plan(indptr, m, n, ch=ch)
        got = ko.spmv_onehot(indptr, indices, data, x, m, n, p)
        again = ko.spmv_onehot(indptr, indices, data, x, m, n, p)
        torch.cuda.synchronize()
        assert_bitwise(got, again)
        assert not p.counters.any()  # every closing block reset its counter
        _assert_rowwise(got, (m, n, *host), x)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SPMV_EDGE))
def test_binned_plan_kernels_match_plain(dev, name):
    from spmm_tpu_torch.ops.kernels import spmv_binned as kb

    m, n, *host = _edge_arrays(name)
    indptr, indices, data = _on(dev, *host)
    before = _build.LAUNCHES["spmv_binned_plan"]
    p = kb.spmv_binned_plan(indptr, indices, data, m, n)
    assert _build.LAUNCHES["spmv_binned_plan"] == before + 1
    rows, class_off, piece_end, piece_row, _ = kb.spmv_binned_plan_plain(
        indptr, m, p.piece_row.numel())
    torch.cuda.synchronize()
    for got, want in ((p.rows, rows), (p.class_off, class_off),
                      (p.piece_end, piece_end)):
        assert_bitwise(got, want)
    total = int(piece_end[-1])
    assert_bitwise(p.piece_row[:total], piece_row[:total])
    # each cut row's counter, at its first piece, is 0 for the first launch
    hubs = p.rows[int(class_off[-2]):].long()
    first = torch.cat([piece_end.new_zeros(1), piece_end[:-1]])[hubs].long()
    assert not p.counters[first].any()


def _device_events(fn):
    """(kernel names, memset count) of one call of `fn` in a torch.profiler
    trace, or None where the trace holds no device events."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, memsets = [], 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memset" in e.name.lower():
            memsets += 1
        elif "memcpy" not in e.name.lower():
            kernels.append(e.name)
    if not kernels and not memsets:
        return None
    return kernels, memsets


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["binned", "onehot", "routed"])
def test_spmv_call_is_one_launch_and_no_memset(dev, kernel):
    """On the hub_pieces edge, whose long rows take each kernel's join."""
    from spmm_tpu_torch.ops.kernels import spmv_binned as kb
    from spmm_tpu_torch.ops.kernels import spmv_onehot as ko
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    m, n, *host = _edge_arrays("hub_pieces")
    indptr, indices, data = _on(dev, *host)
    x = torch.ones(n, device=dev)
    if kernel == "binned":
        p = kb.spmv_binned_plan(indptr, indices, data, m, n)
        call = lambda: kb.spmv_binned(x, p)  # noqa: E731
    elif kernel == "onehot":
        p = ko.spmv_onehot_plan(indptr, m, n)
        call = lambda: ko.spmv_onehot(  # noqa: E731
            indptr, indices, data, x, m, n, p)
    else:
        p = kr.spmv_routed_plan(indptr, indices, data, m, n)
        assert p.chunk_row.numel() > p.long_rows.numel() > 0
        call = lambda: kr.spmv_routed(x, p)  # noqa: E731
    key = f"spmv_{kernel}"
    before = _build.LAUNCHES[key]
    call()
    assert _build.LAUNCHES[key] == before + 1
    seen = _device_events(call)
    if seen is None:
        pytest.skip("the profiler's trace holds no device events here")
    kernels, memsets = seen
    assert memsets == 0 and len(kernels) == 1, seen


@pytest.mark.gpu
def test_compress_call_is_one_launch_and_no_memset(dev):
    from spmm_tpu_torch.ops.kernels import route

    c, mask, nnz = masked_dense(300, 500, 20000, seed=4)
    plan = route.compress_route_plan(mask, 500, dev)
    c = torch.from_numpy(c).to(dev)
    prev = torch.ones(nnz, device=dev)
    for call in (lambda: route.extract_routed(c, plan, 0.5),
                 lambda: route.extract_routed(c, plan, 0.5, c_prev=prev,
                                              beta=-1.0, out=prev)):
        before = _build.LAUNCHES["compress_routed"]
        call()
        assert _build.LAUNCHES["compress_routed"] == before + 1
        seen = _device_events(call)
        if seen is None:
            pytest.skip("the profiler's trace holds no device events here")
        kernels, memsets = seen
        assert memsets == 0 and len(kernels) == 1, seen


@pytest.mark.gpu
def test_expand_and_extract_calls_launch_once(dev):
    """expand_routed: one kernel and no memset or fill in a call's trace,
    with and without the pattern; extract_roll: its C entry's memset of
    the status words and one kernel, nothing else."""
    from spmm_tpu_torch.ops.kernels import route

    indptr, indices, data = csr_arrays(300, 1000, 0.05, seed=5)
    plan = route.expand_route_plan(indptr, indices, 300, 1000, dev)
    vals = torch.from_numpy(data).to(dev)
    ws = torch.empty(300, 1000, device=dev)
    c, mask, nnz = _on(dev, *masked_dense(300, 500, 20000, seed=4)[:2]) + (
        130_000,)
    for key, call, most in (
            ("expand_routed", lambda: route.densify_routed(vals, plan), 1),
            ("expand_routed", lambda: route.densify_routed(
                vals, plan, emit_pattern=False, out=ws), 1),
            ("extract_roll", lambda: extract_roll(c, mask, nnz), 2)):
        before = _build.LAUNCHES[key]
        call()
        assert _build.LAUNCHES[key] == before + 1
        seen = _device_events(call)
        if seen is None:
            pytest.skip("the profiler's trace holds no device events here")
        kernels, memsets = seen
        assert len(kernels) == 1 and len(kernels) + memsets <= most, (key,
                                                                      seen)


@pytest.mark.gpu
def test_route_plans_of_host_arrays_go_to_the_card(dev):
    """A plan of a host array lies on the card by default; a tensor's plan
    where the tensor lies."""
    from spmm_tpu_torch.ops.kernels import route

    indptr, indices, _ = csr_arrays(30, 40, 0.2, seed=3)
    p = route.expand_route_plan(indptr, indices, 30, 40)
    assert p.pos.device.type == p.win.device.type == "cuda"
    mask = np.eye(30, 40, dtype=bool)
    assert route.compress_route_plan(mask, 40).pos.device.type == "cuda"
    t = torch.from_numpy(indices)
    assert route.expand_route_plan(indptr, t, 30, 40).pos.device.type == "cpu"
    assert route.compress_route_plan(torch.from_numpy(mask),
                                     40).pos.device.type == "cpu"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["routed", "binned"])
def test_spmv_plans_of_host_arrays_go_to_the_card(dev, kind):
    """spmv_routed_plan and spmv_binned_plan of host arrays, as JAX's plan
    functions take them: on the card by default, on the CPU with
    device="cpu", and the same SpMV either way."""
    from spmm_tpu_torch.ops.kernels import spmv_binned as kb
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    m, n, *host = _edge_arrays("hub_pieces")
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    if kind == "routed":
        make, call = kr.spmv_routed_plan, kr.spmv_routed
    else:
        make, call = kb.spmv_binned_plan, kb.spmv_binned
    on_card = make(*host, m, n)
    on_cpu = make(*host, m, n, device="cpu")
    assert on_card.indptr.device.type == on_card.counters.device.type == \
        "cuda"
    assert on_cpu.indptr.device.type == "cpu"
    got = call(torch.from_numpy(x).to(dev), on_card)
    torch.cuda.synchronize()
    _assert_rowwise(got, (m, n, *host), torch.from_numpy(x))
    _assert_rowwise(call(torch.from_numpy(x), on_cpu), (m, n, *host),
                    torch.from_numpy(x))


def _full_row_arrays(n: int):
    """3 x n: an empty row, a full row of n entries, an empty row."""
    rng = np.random.default_rng(n)
    indptr = np.array([0, 0, n, n], np.int32)
    data = rng.standard_normal(n).astype(np.float32)
    return 3, n, indptr, np.arange(n, dtype=np.int32), data


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SPMV_EDGE) + ["row_of_563_chunks"])
def test_spmv_routed_joins_many_chunks_on_card(dev, name):
    """cut 8, chunks of 16 entries: rows cross many chunks (up to 182 at
    the span_chunks edge, 563 in one row of 9000), each row closed by one
    warp in chunk order; against the plain version and scipy, bitwise on
    rerun, every counter reset by the warp that closed its row."""
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    m, n, *host = (_full_row_arrays(9000) if name == "row_of_563_chunks"
                   else _edge_arrays(name))
    indptr, indices, data = _on(dev, *host)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(n).astype(
        np.float32)).to(dev)
    p = kr.spmv_routed_plan(indptr, indices, data, m, n, cut=8, ch=16)
    before = _build.LAUNCHES["spmv_routed"]
    got = kr.spmv_routed(x, p)
    again = kr.spmv_routed(x, p)
    plain = kr.spmv_routed_plain(x, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmv_routed"] == before + 2
    assert_bitwise(got, again)
    assert not p.counters.any()
    for y in (got, plain):
        _assert_rowwise(y, (m, n, *host), x)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary (a column slice made contiguous at an odd offset)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SPMV_EDGE) + ["row_of_563_chunks"])
@pytest.mark.parametrize("k", [1, 33, 45, 64, 128])
@pytest.mark.parametrize("layout", ["aligned", "misaligned"])
def test_spmm_routed_kernel_vs_plain_on_card(dev, name, k, layout):
    """spmm_routed over both kinds of plan, at cut 8 and chunks of 16
    entries (long rows closed by up to 563 chunks) and at the default cut
    and chunk: one launch a call, within 1e-6 (|A||X|)_ij of scipy's
    float64 product as its plain version is, bitwise on rerun, every
    counter reset by the group that closed its row.  A misaligned X takes
    the kernel's one-column lanes."""
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    m, n, *host = (_full_row_arrays(9000) if name == "row_of_563_chunks"
                   else _edge_arrays(name))
    indptr, indices, data = _on(dev, *host)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (n, k)).astype(np.float32)).to(dev)
    if layout == "misaligned":
        x = _misaligned(x)
    for kw in (dict(cut=8, ch=16), {}):
        for sell in (True, False):
            p = kr.spmv_routed_plan(indptr, indices, data, m, n, sell=sell,
                                    **kw)
            before = _build.LAUNCHES["spmm_routed"]
            got = kr.spmm_routed(x, p)
            again = kr.spmm_routed(x, p)
            plain = kr.spmm_routed_plain(x, p)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["spmm_routed"] == before + 2
            assert got.shape == (m, k) and got.is_contiguous()
            assert_bitwise(got, again)
            assert not p.counters.any()
            for y in (got, plain):
                _assert_rowwise(y, (m, n, *host), x)


@pytest.mark.gpu
def test_densify_and_spmm_calls_are_one_launch_and_no_fill(dev):
    """One kernel and no memset or fill kernel in a call's trace:
    densify_onehot with and without the pattern; spmm_routed over a plan
    with long rows (sell=True and sell=False) and over one without."""
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    indptr, indices, data = _on(dev, *csr_arrays(300, 1000, 0.05, seed=5))
    m, n, *host = _edge_arrays("hub_pieces")
    hub = _on(dev, *host)
    x = torch.ones(n, 64, device=dev)
    plans = [kr.spmv_routed_plan(*hub, m, n),
             kr.spmv_routed_plan(*hub, m, n, sell=False),
             kr.spmv_routed_plan(*hub, m, n, cut=n)]
    assert plans[0].long_rows.numel() == plans[1].long_rows.numel() > 0
    assert plans[2].long_rows.numel() == 0
    calls = [("densify_onehot", lambda: densify_onehot(
                  indptr, indices, data, 300, 1000)),
             ("densify_onehot", lambda: densify_onehot(
                  indptr, indices, data, 300, 1000, with_pattern=False))]
    calls += [("spmm_routed", lambda p=p: kr.spmm_routed(x, p))
              for p in plans]
    for key, call in calls:
        before = _build.LAUNCHES[key]
        call()
        assert _build.LAUNCHES[key] == before + 1
        seen = _device_events(call)
        if seen is None:
            pytest.skip("the profiler's trace holds no device events here")
        kernels, memsets = seen
        assert memsets == 0 and len(kernels) == 1, (key, seen)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32, torch.int64, torch.float16,
                                   torch.bfloat16, torch.complex64,
                                   torch.bool])
def test_segment_sum_kernel_bitwise_vs_plain(dev, dtype):
    from spmm_tpu_torch.ops.kernels.segment_sum import (
        segment_sum_inorder, segment_sum_inorder_plain)

    rng = np.random.default_rng(6)
    lengths = rng.integers(0, 12, 900)
    lengths[[3, 500]] = [3000, 0]  # one long segment, empty ones
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    base = torch.from_numpy(rng.standard_normal((int(lengths.sum()), 3)))
    if dtype in (torch.float32, torch.float64, torch.complex64):
        # magnitudes spread over e^+-8: the order of the adds shows
        vals = (base * torch.from_numpy(np.exp(rng.uniform(-8, 8, 3)))).to(
            dtype)
    elif dtype == torch.bool:
        vals = base > 0.5
    else:  # half types near 1, integers small: no overflow in 3000 adds
        vals = (base if dtype.is_floating_point else base * 10).to(dtype)
    for v in (vals[:, 0].contiguous(), vals):
        args = (v, torch.from_numpy(starts), torch.from_numpy(lengths))
        want = segment_sum_inorder_plain(*args)
        before = _build.LAUNCHES["segment_sum"]
        got = segment_sum_inorder(*(t.to(dev) for t in args))
        assert _build.LAUNCHES["segment_sum"] == before + 1
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert_bitwise(got, want)


@pytest.mark.gpu
def test_axis_sums_and_diagonal_on_card_vs_cpu(dev):
    from spmm_tpu_torch.models import power_law_rows

    a = power_law_rows(1 << 14, 1 << 14, 16, seed=1, device="cpu")
    b = a.to(dev)
    _build.reset_launches()
    for axis in (0, 1):
        assert_bitwise(b.sum(axis=axis), a.sum(axis=axis))
    for k in (0, 5, -3):
        assert_bitwise(b.diagonal(k), a.diagonal(k))
    assert _build.LAUNCHES["segment_sum"] == 5


@pytest.mark.gpu
def test_spmv_wrappers_reject_other_devices(dev):
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    m, n, *host = _edge_arrays("n_odd")
    indptr, indices, data = _on(dev, *host)
    p = kr.spmv_routed_plan(indptr, indices, data, m, n)
    with pytest.raises(ValueError, match="plan on"):
        kr.spmv_routed(torch.ones(n), p)
    with pytest.raises(ValueError, match="contiguous"):
        kr.spmm_routed(torch.ones((4, n), device=dev).T, p)


# spmv through a plan made for the call: the two plan kernels (counted
# once) and the SpMV kernel
BINNED = {"spmv_binned": 1, "spmv_binned_plan": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("call,counts", [
    (lambda a, x, X: pt.spmv(a, x), BINNED),
    (lambda a, x, X: pt.spmv(a, x, via="csr"), BINNED),
    (lambda a, x, X: pt.spmv(a, x, plan=pt.spmv_plan(a)),
     {"spmv_routed": 1}),
    (lambda a, x, X: pt.spmv(a, x, plan=pt.spmv_plan(a, effort="fast")),
     BINNED),
    (lambda a, x, X: pt.spmv(a, x, via="onehot"), {"spmv_onehot": 1}),
    (lambda a, x, X: pt.spmv(a, x[:40], transa=True), BINNED),
    (lambda a, x, X: pt.spmv(a, x, via="dense"), {"densify_onehot": 1}),
    (lambda a, x, X: pt.spmm(a, X), {"spmm_routed": 1}),
    (lambda a, x, X: pt.spmm(a, X, plan=pt.spmv_plan(a)),
     {"spmm_routed": 1}),
    (lambda a, x, X: pt.spmm(a, X[:40], transa=True), {"spmm_routed": 1}),
    (lambda a, x, X: a @ x, BINNED),
    (lambda a, x, X: pt.matmul(a, X, mode="sparse"), {"spmm_routed": 1}),
    (lambda a, x, X: x[:40] @ a, BINNED),
    (lambda a, x, X: X[:40].T @ a, {"spmm_routed": 1}),
])
def test_entry_points_launch_kernels_and_rerun_bitwise(dev, call, counts):
    a = pt.random(40, 70, 0.2, format="csr", seed=11, device=dev)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(70).astype(np.float32)).to(dev)
    X = torch.from_numpy(rng.standard_normal((70, 33)).astype(
        np.float32)).to(dev)
    _build.reset_launches()
    y1 = call(a, x, X)
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    y2 = call(a, x, X)
    torch.cuda.synchronize()
    assert got == counts
    assert_bitwise(y1, y2)
    assert y1.device == x.device and bool(torch.isfinite(y1).all())


@pytest.mark.gpu
def test_spmv_plan_on_card(dev):
    a = pt.random(50, 60, 0.1, format="csr", seed=12, device=dev)
    tag, p = pt.spmv_plan(a)
    assert tag == "routed" and p.slack >= 1.0
    assert pt.spmv_plan(a, effort="fast")[0] == "binned"
    assert pt.spmv_plan(pt.random(5, 5, 0.0, format="csr", device=dev)) is None


# ---------------------------------------------------------------------------
# the routed SpMV in float64 (HPCG's dtype)
# ---------------------------------------------------------------------------

# a float64 cell's limit on value_err = max|y - r| / max|r| against the
# benchmark's float64 reference: sound float64 runs read at most 1.01e-15
# at HPCG's 104^3, float32 operands about 1e-8
F64_LIMIT = 1e-13


def _cardbench(*parts):
    """A module of the benchmark, loaded by its path (the repository's root
    on the import path, for the benchmark's own imports)."""
    import importlib.util
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "cardbench_" + "_".join(parts).replace(".", "_"),
        root.joinpath("cardbench", *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64_matrix(dev, which):
    """(indptr, indices, data, (m, n)) of HPCG's stencil at 20^3 (made on
    the card by the benchmark's law) or of `f64_csr_arrays` at 300 x 250,
    float64 on the card."""
    if which == "stencil20":
        law = _cardbench("laws", "stencil27.py")
        a = law.make({"grid": [20, 20, 20]}, 0, torch.float64, dev)
        return a.indptr, a.indices, a.data, a.shape
    from torch_port_helpers import f64_csr_arrays

    return (*_on(dev, *f64_csr_arrays(300, 250, seed=5)), (300, 250))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["stencil20", "random300x250"])
@pytest.mark.parametrize("kw", [{}, {"cut": 8, "ch": 16}],
                         ids=["slices", "chunks"])
def test_spmv_routed_f64_on_card(dev, which, kw):
    """The float64 kernel against the benchmark's float64 reference within
    the cell's limit, one launch a call, bitwise on rerun, every counter
    reset; at the plan's defaults (the stencil's rows all in slices, its
    width-27 slices on 2 warps) and with rows past 8 entries in chunks."""
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    indptr, indices, data, (m, n) = _f64_matrix(dev, which)
    p = kr.spmv_routed_plan(indptr, indices, data, m, n, **kw)
    assert p.sell_val.dtype == p.partial.dtype == torch.float64
    if kw:
        assert p.chunk_row.numel() > p.long_rows.numel() > 0
    elif which == "stencil20":
        assert p.classes[2] > 0 and not p.long_rows.numel()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    before = _build.LAUNCHES["spmv_routed"]
    got = kr.spmv_routed(x, p)
    again = kr.spmv_routed(x, p)
    plain = kr.spmv_routed_plain(x, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmv_routed"] == before + 2
    assert got.dtype == torch.float64
    assert_bitwise(got, again)
    assert not p.counters.any()
    ref = _cardbench("reference", "spmv.py").spmv(
        (indptr, indices, data, (m, n)), x)
    for y in (got, plain):
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= F64_LIMIT, err


@pytest.mark.gpu
def test_spmv_plan_f64_entry_on_card(dev):
    """`spmv_plan` of a float64 CSR on the card is the float64 routed plan
    ("fast": None); `spmv(A, x, plan=P)` is one `spmv_routed` launch, no
    memset, no host sync; `spmm` ignores the float64 plan and gives
    `spmm(A, B)`'s bits."""
    indptr, indices, data, (m, n) = _f64_matrix(dev, "stencil20")
    a = pt.CSR.from_parts(indptr, indices, data, (m, n), canonical=True)
    tag, p = pt.spmv_plan(a)
    assert tag == "routed" and p.sell_val.dtype == torch.float64
    assert pt.spmv_plan(a, effort="fast") is None
    x = torch.rand(n, device=dev, dtype=torch.float64)
    call = lambda: pt.spmv(a, x, plan=(tag, p))  # noqa: E731
    _build.reset_launches()
    y = call()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"spmv_routed": 1}
    assert_bitwise(y, pt.spmv(a, x, plan=(tag, p)))
    assert _host_syncs(call) == 0
    seen = _device_events(call)
    if seen is not None:
        kernels, memsets = seen
        assert memsets == 0 and len(kernels) == 1, seen
    B = torch.rand((n, 5), device=dev, dtype=torch.float64)
    assert_bitwise(pt.spmm(a, B, plan=(tag, p)), pt.spmm(a, B))


@pytest.mark.gpu
def test_spmm_graph500_mean_on_card(dev):
    """Graph500's Kronecker graph at scale 14 (the benchmark's law, made on
    the card), 1/deg values, H of k = 100 float32 columns: `spmm(A, H)` is
    one `spmm_routed` launch and three host syncs (its chunk plan's), its
    hub rows on the kernel's chunk path; bitwise on rerun and the plan's
    own launch, every counter left at zero, and within the limit of the
    cell g500-s22.sage-mean-k100 of the benchmark's float64 reference."""
    import json
    from pathlib import Path

    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    cell = (Path(__file__).resolve().parents[1] / "cardbench" / "workloads"
            / "g500-s22.sage-mean-k100.json")
    limit = json.loads(cell.read_text())["limits"]["value_err"]
    law = _cardbench("laws", "kronecker.py")
    g = law.make({"scale": 14, "edgefactor": 16,
                  "initiator": [0.57, 0.19, 0.19], "values": "mean"},
                 2**31 + 14, torch.float32, dev)
    a = pt.CSR.from_parts(g.indptr, g.indices, g.data, g.shape,
                          canonical=True)
    n = g.shape[1]
    h = torch.rand((n, 100), generator=torch.Generator(device=dev)
                   .manual_seed(7), device=dev)
    call = lambda: pt.spmm(a, h)  # noqa: E731
    _build.reset_launches()
    y = call()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"spmm_routed": 1}
    assert _host_syncs(call) == 3
    p = kr.spmv_routed_plan(g.indptr, g.indices, g.data, n, n, sell=False)
    assert p.chunk_row.numel() > p.long_rows.numel() > 0
    yp = kr.spmm_routed(h, p)
    torch.cuda.synchronize()
    assert not p.counters.any()
    assert_bitwise(y, call())
    assert_bitwise(y, yp)
    ref = _cardbench("reference", "spmm.py").spmm(g, h)
    err = float((y.double() - ref).abs().max() / ref.abs().max())
    assert err <= limit, err


def routed_f32_digest(dev) -> str:
    """sha256 of the float32 `spmv_routed` answers of the cases above:
    every SPMV_EDGE matrix and the row of 563 chunks, at cut 32 / ch 64
    and cut 8 / ch 16, x standard-normal from a fixed seed."""
    import hashlib

    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    h = hashlib.sha256()
    for name in list(SPMV_EDGE) + ["row_of_563_chunks"]:
        m, n, *host = (_full_row_arrays(9000) if name == "row_of_563_chunks"
                       else _edge_arrays(name))
        arrays = _on(dev, *host)
        x = torch.from_numpy(np.random.default_rng(8).standard_normal(
            n).astype(np.float32)).to(dev)
        for cut, ch in ((32, 64), (8, 16)):
            p = kr.spmv_routed_plan(*arrays, m, n, cut=cut, ch=ch)
            h.update(f"{name}|{cut}|{ch}|".encode())
            h.update(kr.spmv_routed(x, p).cpu().numpy().tobytes())
    return h.hexdigest()


# `routed_f32_digest` on an H100 at the commit before the float64 kernel
# (09b2aaf): the float32 instantiation keeps the float kernel's bits
ROUTED_F32_PIN = ("8e46322332318e5e92e99ddc838acff1"
                  "7d84fca8ffa9d05f42c57234476fdad6")


@pytest.mark.gpu
def test_spmv_routed_f32_keeps_its_bits(dev):
    assert routed_f32_digest(dev) == ROUTED_F32_PIN


# ---------------------------------------------------------------------------
# serving: expand_routed / compress_routed, SpgemmPlan; ESC on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,density,kw", [
    (64, 128, 0.1, {}),
    (33, 45, 0.3, {"zeros": 3, "empty_rows": (0, 7, 32)}),
    (1, 5000, 0.2, {}),       # one row
    (3000, 7, 0.5, {}),       # m*k not a multiple of 128
    (3, 70_000, 0.01, {}),    # rows wider than a 4096-cell window
    (1, 4099, 0.3, {}),       # m = 1, a ragged last window of 3 cells
    (9000, 1, 0.5, {}), (3000, 3, 0.4, {}), (700, 15, 0.2, {}),
    (700, 17, 0.9, {}),       # many rows a window
    (50, 40, 0.2, {"unsorted": True}),    # out of order: the plan sorts
    (200, 333, 0.05, {"unsorted": True}),
])
@pytest.mark.parametrize("emit_pattern", [True, False])
def test_expand_routed_kernel_bitwise_vs_plain(dev, m, k, density, kw,
                                               emit_pattern):
    """Bitwise the plain version, on rerun, into a given workspace (filled
    with garbage first: every cell is overwritten) and into one off 16-byte
    alignment."""
    from spmm_tpu_torch.ops.kernels import route
    from torch_port_helpers import unsorted_csr_arrays

    kw = dict(kw)
    if kw.pop("unsorted", False):
        indptr, indices, data = unsorted_csr_arrays(m, k, density, m + k,
                                                    max_run=1)
    else:
        indptr, indices, data = csr_arrays(m, k, density, seed=m + k, **kw)
    data[1::7] = -0.0  # bits travel, sign of zero included
    plan = route.expand_route_plan(indptr, indices, m, k, dev)
    assert (plan.src is not None) == ((m, k) in ((50, 40), (200, 333)))
    vals = torch.from_numpy(data).to(dev)
    before = _build.LAUNCHES["expand_routed"]
    got = route.densify_routed(vals, plan, emit_pattern)
    assert _build.LAUNCHES["expand_routed"] == before + 1
    want = route.densify_routed_plain(vals, plan, emit_pattern)
    again = route.densify_routed(vals, plan, emit_pattern)
    ws = torch.full((m, k), float("nan"), device=dev)
    reused = route.densify_routed(vals, plan, emit_pattern, out=ws)
    buf = torch.full((m * k + 1,), 3.0, device=dev)
    odd = buf[1:].view(m, k)
    assert odd.data_ptr() % 16
    shifted = route.densify_routed(vals, plan, emit_pattern, out=odd)
    torch.cuda.synchronize()
    assert (reused if not emit_pattern else reused[0]) is ws
    want = (want,) if not emit_pattern else want
    for out in (got, again, reused, shifted):
        for x, y in zip((out,) if not emit_pattern else out, want):
            assert_bitwise(x, y)


@pytest.mark.gpu
def test_expand_routed_empty_launches_nothing(dev):
    from spmm_tpu_torch.ops.kernels import route

    indptr, indices, data = csr_arrays(6, 9, 0.0, seed=1)
    plan = route.expand_route_plan(indptr, indices, 6, 9, dev)
    before = dict(_build.LAUNCHES)
    val, pat = route.densify_routed(torch.from_numpy(data).to(dev), plan)
    assert _build.LAUNCHES == before
    assert not val.any() and not pat.any() and val.shape == (6, 9)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,g", [(64, 256, 33), (1, 1000, 400),
                                   (500, 7, 3400), (128, 128, 0)])
@pytest.mark.parametrize("alpha,beta", [(1.0, None), (-1.7, None),
                                        (0.5, -2.0), (3.0, 1.0)])
@pytest.mark.parametrize("wide", [False, True])
def test_compress_routed_kernel_bitwise_vs_plain(dev, m, n, g, alpha, beta,
                                                 wide):
    """Including the fused beta*prev + alpha*c[pos] (no FMA contraction)
    written in place into prev; with the plan's int32 positions and with
    int64 ones (the type of a plan past 2^31 cells, swapped into the plan
    here)."""
    from spmm_tpu_torch.ops.kernels import route

    c, mask, nnz = masked_dense(m, n, g, seed=g + 3)
    plan = route.compress_route_plan(mask, n, dev)
    assert plan.pos.dtype == torch.int32
    if wide:
        plan = plan._replace(pos=plan.pos.long())
    c = torch.from_numpy(c).to(dev)
    kw = {}
    if beta is not None:
        prev = torch.from_numpy(np.random.default_rng(1).standard_normal(
            nnz).astype(np.float32)).to(dev)
        kw = {"c_prev": prev, "beta": beta}
    want = route.extract_routed_plain(c, plan, alpha, **kw)
    before = _build.LAUNCHES["compress_routed"]
    got = route.extract_routed(c, plan, alpha, **kw)
    assert _build.LAUNCHES["compress_routed"] == before + 1
    assert_bitwise(got, want)
    # out and prev off 16-byte alignment, as a row of a batch can be
    shifted = dict(kw)
    if beta is not None:
        shifted["c_prev"] = torch.cat([prev[:1], prev])[1:]
    buf = torch.empty(nnz + 1, device=dev)
    assert_bitwise(route.extract_routed(c, plan, alpha, out=buf[1:],
                                        **shifted), want)
    if beta is not None:
        inplace = route.extract_routed(c, plan, alpha, out=kw["c_prev"], **kw)
        torch.cuda.synchronize()
        assert inplace is kw["c_prev"]
        assert_bitwise(inplace, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,density", [(40, 72, 56, 0.2),
                                           (256, 256, 256, 0.1)])
def test_spgemm_plan_on_card(dev, m, k, n, density):
    a = pt.random(m, k, density, format="csr", seed=5, device="cpu")
    b = pt.random(k, n, density, format="csr", seed=6, device="cpu")
    want = pt.spgemm_plan(a, b)(a.data, b.data)  # CPU: plain versions
    ad, bd = a.to(dev), b.to(dev)
    plan = pt.spgemm_plan(ad, bd)
    assert plan.routed == (True, True, True)
    _build.reset_launches()
    got = plan(ad.data, bd.data)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "expand_routed": 2, "compress_routed": 1}
    again = plan(ad.data, bd.data)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.has_canonical_format
    assert_bitwise(got.indptr, want.indptr)
    assert_bitwise(got.indices, want.indices)
    w = want.data.numpy()
    np.testing.assert_allclose(got.data.cpu().numpy(), w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())
    assert_bitwise(again.data, got.data)
    K = 3
    av = torch.stack([ad.data * (i + 1) for i in range(K)])
    bv = torch.stack([bd.data] * K)
    batch = plan.values_batch(av, bv, alpha=0.5)
    for i in range(K):
        assert_bitwise(batch[i], plan.values(av[i], bv[i], alpha=0.5))
    c = got.data.clone()
    assert plan.values_accumulate(c, ad.data, bd.data, -1.0, 1.0) is c
    assert not c.any()


@pytest.mark.gpu
@pytest.mark.parametrize("alg,cf", [(2, 0.2), (3, 1.0), (3, 0.2), (3, 0.05)])
def test_esc_on_card_bitwise_vs_cpu(dev, alg, cf):
    a = pt.random(300, 200, 0.05, format="csr", seed=7, device="cpu")
    b = pt.random(200, 250, 0.05, format="csr", seed=8, device="cpu")
    want = pt.spgemm(a, b, alpha=1.5, alg=alg, chunk_fraction=cf, impl="esc")
    got = pt.spgemm(a.to(dev), b.to(dev), alpha=1.5, alg=alg,
                    chunk_fraction=cf, impl="esc")
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.has_canonical_format
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert_bitwise(x, y)


# runs of equal pairs for csrc/esc_compress.cu: (lengths, m, n); a run of
# 2040 singles first puts the long runs across the 2048-position tiles
ESC_RUNS = {
    "1-70": (list(range(1, 71)) * 4, 500, 300),
    "1023-1025": ([1] * 2040 + [1023, 1024, 1025, 1, 2, 3], 700, 900),
    "4097": ([1] * 2040 + [4097, 5, 4097, 1], 300, 300),
    "70001": ([2] * 1020 + [70001, 3, 70001], 50, 40),
    "unfused": ([1, 2, 3, 5, 8, 33] * 700, 70000, 70000),  # m*n >= 2^31
}


def _esc_triplets(lengths, m, n, dtype, dev, seed, neg_zero=False):
    """Lex-sorted (row, col, val) on `dev`, val of the torch `dtype`, with
    runs of `lengths` at distinct pairs in order, shuffled, rows up to
    m - 1 (the last rows empty), a tenth of the values (of each part of a
    complex value) -0.0, all of them with `neg_zero`."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.asarray(lengths))
    keys = np.sort(rng.choice((m - 3) * n, lengths.size, replace=False))
    keys = np.repeat(keys, lengths)

    def part():
        x = rng.standard_normal(keys.size) * 10.0 ** rng.integers(
            -3, 4, keys.size)
        x[rng.random(keys.size) < 0.1] = -0.0
        if neg_zero:
            x[:] = -0.0
        return torch.from_numpy(x)

    vals = (torch.complex(part(), part()) if dtype.is_complex
            else part()).to(dtype)
    row, col = _on(dev, (keys // n).astype(np.int32),
                   (keys % n).astype(np.int32))
    return row, col, vals.to(dev)


def _esc_compress_both(row, col, val, alpha, m):
    """(count, indptr, col, val) of the kernels and of the plain version
    on the same CUDA tensors."""
    from spmm_tpu_torch.ops.kernels import esc_compress as ec

    outs = []
    for count, compress in ((ec.count_runs, ec.compress_runs),
                            (ec.count_runs_plain, ec.compress_runs_plain)):
        nnz = int(count(row, col))
        got = (torch.empty(m + 1, dtype=torch.int32, device=row.device),
               torch.empty(nnz, dtype=torch.int32, device=row.device),
               torch.empty(nnz, dtype=val.dtype, device=row.device))
        compress(row, col, val, alpha, *got)
        outs.append((nnz, *got))
    torch.cuda.synchronize()
    return outs


ESC_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.complex64,
              torch.complex128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,alpha", [
    *((d, a) for d in ESC_DTYPES for a in (1.0, 1.5)),
    (torch.complex64, 1.5 - 0.25j), (torch.complex128, 1.5 - 0.25j)])
@pytest.mark.parametrize("name", [*ESC_RUNS, "neg_zero"])
def test_esc_compress_kernels_bitwise_vs_plain(dev, name, dtype, alpha):
    """`count_runs` and `compress_runs` against their plain versions (the
    doubling tree's torch passes) on the card, bitwise, in every dtype ESC
    takes: runs of 1-70, 1023-1025, 4097 and 70 001 across tile
    boundaries, -0.0 products, an m*n past 2^31 (no fused key), empty last
    rows, a complex alpha; bitwise on rerun."""
    lengths, m, n = ESC_RUNS.get(name, ESC_RUNS["1-70"])
    row, col, val = _esc_triplets(lengths, m, n, dtype, dev, len(name),
                                  neg_zero=name == "neg_zero")
    (nnz, *got), (want_nnz, *want) = _esc_compress_both(row, col, val,
                                                        alpha, m)
    assert nnz == want_nnz == len(lengths)
    for x, y in zip(got, want):
        assert_bitwise(x, y)
    if name == "neg_zero" and not dtype.is_complex:
        assert torch.signbit(got[2]).all()
    (again_nnz, *again), _ = _esc_compress_both(row, col, val, alpha, m)
    for x, y in zip(again, got):
        assert_bitwise(x, y)


@pytest.mark.gpu
def test_esc_compress_chunks_and_empty_on_card(dev):
    """Two chunks of rows compressed into slices of one output at their
    offsets give the whole call's bits (alg3's form); no product launches
    nothing and leaves indptr at its base."""
    from spmm_tpu_torch.ops.kernels import esc_compress as ec

    lengths, m, n = ESC_RUNS["1023-1025"]
    row, col, val = _esc_triplets(lengths, m, n, torch.float32, dev, 3)
    (nnz, *whole), _ = _esc_compress_both(row, col, val, 1.5, m)
    cut = m // 2
    split = int(torch.searchsorted(row, torch.tensor(cut, device=dev)))
    off = int(whole[0][cut])
    parts = [torch.empty_like(x) for x in whole]
    for lo, hi, p0, p1, base, end in ((0, cut, 0, split, 0, off),
                                      (cut, m, split, row.numel(), off,
                                       nnz)):
        ec.compress_runs(row[p0:p1], col[p0:p1], val[p0:p1], 1.5,
                         parts[0][lo:hi + 1], parts[1][base:end],
                         parts[2][base:end], lo, base)
    for x, y in zip(parts, whole):
        assert_bitwise(x, y)
    _build.reset_launches()
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    assert int(ec.count_runs(empty, empty)) == 0
    indptr = torch.full((5,), -1, dtype=torch.int32, device=dev)
    ec.compress_runs(empty, empty, torch.empty(0, device=dev), 2.0, indptr,
                     empty, torch.empty(0, device=dev), 3, 7)
    assert indptr.tolist() == [7] * 5
    assert not any(_build.LAUNCHES.values())


@pytest.mark.gpu
def test_esc_compress_raises_on_another_dtype_on_card(dev):
    """A dtype ESC does not take raises on the card: no plain fallback."""
    from spmm_tpu_torch.ops.kernels import esc_compress as ec

    row, col, val = _esc_triplets([1, 2, 3], 10, 10, torch.float16, dev, 1)
    out = (torch.empty(11, dtype=torch.int32, device=dev),
           torch.empty(3, dtype=torch.int32, device=dev),
           torch.empty(3, dtype=torch.float16, device=dev))
    with pytest.raises(NotImplementedError, match="float16"):
        ec.compress_runs(row, col, val, 1.0, *out)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.0, 0.2, 0.05])
def test_esc_alg3_chunks_without_products_on_card(dev, cf):
    """alg3 ESC where a chunk of rows holds no product (empty rows of A,
    the last ones among them): bitwise the CPU's run, indptr included."""
    indptr, indices, data = csr_arrays(50, 40, 0.2, 4,
                                       empty_rows=(0, 9, 47, 48, 49))
    a = pt.CSR.from_parts(indptr, indices, data, (50, 40), device="cpu")
    b = pt.random(40, 30, 0.2, format="csr", seed=5, device="cpu")
    want = pt.spgemm(a, b, alpha=1.5, alg=3, chunk_fraction=cf, impl="esc")
    got = pt.spgemm(a.to(dev), b.to(dev), alpha=1.5, alg=3,
                    chunk_fraction=cf, impl="esc")
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert_bitwise(x, y)


@pytest.mark.gpu
def test_esc_launches_two_kernels_a_call(dev, capsys):
    """ESC alg2 launches `esc_count` and `esc_compress` once each and no
    other kernel of the port; alg3 ESC each once per chunk (every chunk
    holds products here)."""
    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    a = pt.random(300, 200, 0.05, format="csr", seed=7, device=dev)
    b = pt.random(200, 250, 0.05, format="csr", seed=8, device=dev)
    c = pt.spgemm(a, b, alg=2, impl="esc")
    assert (torch.diff(c.indptr) > 0).all()
    _build.reset_launches()
    pt.spgemm(a, b, alg=2, impl="esc")
    want = dict.fromkeys(_build.LAUNCHES, 0)
    assert _build.LAUNCHES == dict(want, esc_count=1, esc_compress=1)
    for cf in (0.2, 0.05):
        capsys.readouterr()
        _build.reset_launches()
        sg._spgemm_alg3_esc(a, b, 1.0, cf, verbose=True)
        chunks = int(capsys.readouterr().out.split("chunks=")[1].split()[0])
        assert chunks > 1
        assert _build.LAUNCHES == dict(want, esc_count=chunks,
                                       esc_compress=chunks)


@pytest.mark.gpu
def test_sum_duplicates_on_card_bitwise_vs_cpu(dev):
    from torch_port_helpers import unsorted_csr_arrays

    arrays = unsorted_csr_arrays(120, 90, 0.1, 9, max_run=4)
    want = pt.CSR.from_parts(*arrays, (120, 90),
                             device="cpu").sum_duplicates()
    got = pt.CSR.from_parts(*arrays, (120, 90), device=dev).sum_duplicates()
    assert got.has_canonical_format
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert_bitwise(x, y)


def _host_syncs(fn) -> int:
    """How many synchronizing CUDA calls `fn` makes: torch's sync debug
    mode warns once for each (its one-time notice that the mode is a
    prototype also says "synchronizing", so match the warning's own
    words)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_host_syncs_on_card(dev):
    """A plan call and `_alg1_fixed` sync never; ESC alg2 and alg3 read
    back twice each
    (alg2: P and nnz; alg3: the row products and the chunk counts), as
    the JAX package does; `sum_duplicates` once."""
    from torch_port_helpers import unsorted_csr_arrays

    a = pt.random(200, 150, 0.05, format="csr", seed=1, device=dev)
    b = pt.random(150, 180, 0.05, format="csr", seed=2, device=dev)
    plan = pt.spgemm_plan(a, b)
    plan(a.data, b.data)
    assert _host_syncs(lambda: plan(a.data, b.data)) == 0
    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    sg._alg1_fixed(a, b, 1.0, 900)
    assert _host_syncs(lambda: sg._alg1_fixed(a, b, 1.0, 900)) == 0
    assert _host_syncs(lambda: plan.values_accumulate(
        plan.values(a.data, b.data), a.data, b.data)) == 0
    assert _host_syncs(lambda: pt.spgemm(a, b, alg=2, impl="esc")) == 2
    assert _host_syncs(lambda: pt.spgemm(a, b, alg=3, chunk_fraction=0.1,
                                         impl="esc")) == 2
    u = pt.CSR.from_parts(*unsorted_csr_arrays(50, 40, 0.2, 3), (50, 40),
                          device=dev)
    assert _host_syncs(u.sum_duplicates) == 1


@pytest.mark.gpu
def test_alg0_runs_esc_at_8192_sparse(dev):
    """spgemm(A, B) at 8192^2, density 1e-3 (0.55 M products), opens
    `spgemm.alg2.esc` and not `spgemm.alg1`, with ESC's two readbacks: its
    answer is bitwise `alg=2, impl="esc"` and its own rerun, alg1's
    structure, and alg1's values within 1e-6 of max|C|."""
    from spmm_tpu_torch.utils import profiler

    a = pt.random(8192, 8192, 1e-3, format="csr", seed=12, device=dev)
    b = pt.random(8192, 8192, 1e-3, format="csr", seed=13, device=dev)
    pt.spgemm(a, b)
    profiler.reset_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = pt.spgemm(a, b)
        totals = profiler.span_totals()
    finally:
        profiler.reset_spans()
    assert {n for n in totals if not n.startswith("sync.")} == {
        "spgemm", "spgemm.alg2.esc"}
    assert sorted(n for n in totals if n.startswith("sync.")) == [
        "sync.nnz", "sync.products"]
    assert _host_syncs(lambda: pt.spgemm(a, b)) == 2
    for other in (pt.spgemm(a, b, alg=2, impl="esc"), pt.spgemm(a, b)):
        for x, y in ((got.indptr, other.indptr),
                     (got.indices, other.indices), (got.data, other.data)):
            assert_bitwise(x, y)
    c1 = pt.spgemm(a, b, alg=1)
    assert_bitwise(got.indptr, c1.indptr)
    assert_bitwise(got.indices, c1.indices)
    err = (got.data - c1.data).abs().max().item()
    assert err <= 1e-6 * c1.data.abs().max().item()


# ---------------------------------------------------------------------------
# device defaults; densify_onehot_pattern; the blocked alg2/alg3 engines
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_entry_points_default_to_the_card(dev):
    import scipy.sparse as sp

    from spmm_tpu_torch.models import power_law_rows

    indptr, indices, data = csr_arrays(8, 8, 0.5, seed=3)
    s = sp.csr_matrix((data, indices, indptr), shape=(8, 8))
    for a in (pt.random(8, 8, 0.5, format="csr"), pt.from_reference(s),
              pt.CSR.from_scipy(s), pt.CSR.from_parts(indptr, indices, data,
                                                      (8, 8)),
              power_law_rows(64, 64, 4, seed=0)):
        assert a.device == dev
        assert a.indptr.device == a.indices.device == dev
    # a tensor keeps its device
    cpu = pt.CSR.from_parts(indptr, indices, torch.from_numpy(data), (8, 8))
    assert cpu.device == torch.device("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,density,kw", [
    (64, 128, 0.1, {}),
    (100, 300, 0.05, {}),
    (33, 45, 0.3, {"zeros": 3, "empty_rows": (0, 7, 32)}),
    (1, 5000, 0.2, {}),
    (3000, 7, 0.5, {}),
])
def test_densify_pattern_kernel_bitwise_vs_plain(dev, m, k, density, kw):
    from spmm_tpu_torch.ops.kernels.densify_onehot import (
        densify_onehot_pattern, densify_onehot_pattern_plain)

    indptr, indices, _ = _on(dev, *csr_arrays(m, k, density, seed=m + k,
                                              **kw))
    before = _build.LAUNCHES["densify_onehot_pattern"]
    got = densify_onehot_pattern(indptr, indices, m, k)
    assert _build.LAUNCHES["densify_onehot_pattern"] == before + 1
    want = densify_onehot_pattern_plain(indptr, indices, m, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    assert_bitwise(got, want)


@pytest.mark.gpu
def test_densify_pattern_empty_launches_nothing(dev):
    from spmm_tpu_torch.ops.kernels.densify_onehot import (
        densify_onehot_pattern)

    indptr, indices, _ = _on(dev, *csr_arrays(6, 9, 0.0, seed=1))
    before = dict(_build.LAUNCHES)
    pat = densify_onehot_pattern(indptr, indices, 6, 9)
    assert _build.LAUNCHES == before
    assert not pat.any() and pat.shape == (6, 9)


def _pattern_arrays(m: int, k: int, per_row: int, seed: int):
    """A CSR structure with each row's column ids drawn with replacement and
    left unsorted (duplicates within a row), rows 2, 5, 8, ... empty."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, per_row + 1, m)
    counts[2::3] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, k, int(indptr[-1])).astype(np.int32)
    if indices.size > 1:
        indices[1] = indices[0]  # a duplicate at least
    return indptr, indices


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,per_row", [
    (40, 37, 30),        # unsorted, duplicates, k not a multiple of 8
    (3, 10_000, 900),    # rows wider than one 4096-cell window
    (700, 13, 9),        # windows that start and end inside rows
    (1, 4099, 2000),     # m = 1 over two windows, a ragged last window
    (9, 4096, 50),       # rows exactly one window wide
])
def test_densify_pattern_unsorted_duplicates_wide(dev, m, k, per_row):
    from spmm_tpu_torch.ops.kernels.densify_onehot import (
        densify_onehot_pattern, densify_onehot_pattern_plain)

    indptr, indices = _on(dev, *_pattern_arrays(m, k, per_row, seed=m + k))
    got = densify_onehot_pattern(indptr, indices, m, k)
    want = densify_onehot_pattern_plain(indptr, indices, m, k)
    torch.cuda.synchronize()
    assert got.shape == (m, k)
    assert_bitwise(got, want)


@pytest.mark.gpu
def test_pattern_and_bsr_calls_are_one_launch_and_no_fill(dev):
    """One kernel and no memset or fill kernel in a call's trace."""
    from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm
    from spmm_tpu_torch.ops.kernels.densify_onehot import (
        densify_onehot_pattern)

    indptr, indices = _on(dev, *_pattern_arrays(300, 1000, 40, seed=5))
    a, ab = _bsr_on(dev, 256, 512, 0.05, (8, 128), seed=6)
    x = torch.ones(512, 96, device=dev)
    for key, call in (
            ("densify_onehot_pattern",
             lambda: densify_onehot_pattern(indptr, indices, 300, 1000)),
            ("bsr_spmm",
             lambda: bsr_spmm(ab.indptr, ab.indices, ab.data, x, 256))):
        before = _build.LAUNCHES[key]
        call()
        assert _build.LAUNCHES[key] == before + 1
        seen = _device_events(call)
        if seen is None:
            pytest.skip("the profiler's trace holds no device events here")
        kernels, memsets = seen
        assert memsets == 0 and len(kernels) == 1, (key, seen)


def _scipy_check(a, b, c, alpha=1.0):
    """Structure bitwise against scipy's pattern product, values within
    rtol 1e-6 + atol 1e-6 * max|C| of its float64 product."""
    sa, sb = a.to_scipy(), b.to_scipy()
    ones = [sp_ones(x) for x in (sa, sb)]
    struct = (ones[0] @ ones[1]).tocsr()
    struct.sort_indices()
    assert_bitwise(c.indptr, struct.indptr.astype(np.int32))
    assert_bitwise(c.indices, struct.indices.astype(np.int32))
    ref = (alpha * (sa.astype(np.float64) @ sb.astype(np.float64))).tocsr()
    rows = np.repeat(np.arange(c.shape[0]), np.diff(struct.indptr))
    want = np.asarray(ref[rows, struct.indices]).ravel()
    got = c.data.cpu().double().numpy()
    tol = 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()


def sp_ones(x):
    import scipy.sparse as sp

    return sp.csr_matrix((np.ones(x.nnz), x.indices, x.indptr), x.shape)


def _bitwise_csr(x, y):
    for u, v in ((x.indptr, y.indptr), (x.indices, y.indices),
                 (x.data, y.data)):
        assert_bitwise(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [0.05, 0.3, 1.0])
def test_blocked_engines_on_card(dev, cf, monkeypatch):
    """alg2 (both engines) and every alg3 engine against scipy; each set
    bitwise within itself and on rerun; the pattern, value and extraction
    kernels all launched."""
    from spmm_tpu_torch.ops import spgemm_blocked as bl

    a = pt.random(300, 200, 0.1, format="csr", seed=21, device=dev)
    b = pt.random(200, 260, 0.1, format="csr", seed=22, device=dev)
    _build.reset_launches()
    c2 = pt.spgemm(a, b, alpha=-2.5, alg=2)
    assert all(_build.LAUNCHES[x] for x in
               ("densify_onehot_pattern", "densify_onehot", "extract_roll"))
    _scipy_check(a, b, c2, -2.5)
    _bitwise_csr(pt.spgemm(a, b, alpha=-2.5, alg=2), c2)
    monkeypatch.setattr(bl, "_ALG2_MAX_UNROLL_TILES", 1)
    _bitwise_csr(pt.spgemm(a, b, alpha=-2.5, alg=2), c2)
    outs = [bl.spgemm_alg3_blocked(a, b, -2.5, cf, engine=e)
            for e in ("group", "unrolled", "scan3", "scan2")]
    torch.cuda.synchronize()
    _scipy_check(a, b, outs[0], -2.5)
    for c in outs[1:]:
        _bitwise_csr(c, outs[0])
    _bitwise_csr(pt.spgemm(a, b, alpha=-2.5, alg=3, chunk_fraction=cf),
                 outs[0])


@pytest.mark.gpu
def test_blocked_host_syncs_do_not_grow_with_blocks(dev, monkeypatch):
    """One call's host syncs are the same at two sizes with different
    numbers of tiles and panels, for each engine."""
    from spmm_tpu_torch.ops import spgemm_blocked as bl

    small = (pt.random(200, 150, 0.1, format="csr", seed=1, device=dev),
             pt.random(150, 180, 0.1, format="csr", seed=2, device=dev))
    large = (pt.random(700, 300, 0.05, format="csr", seed=3, device=dev),
             pt.random(300, 650, 0.05, format="csr", seed=4, device=dev))
    calls = [("alg2", lambda a, b: pt.spgemm(a, b, alg=2))]
    calls += [(e, lambda a, b, e=e: bl.spgemm_alg3_blocked(
        a, b, 1.0, 0.2, engine=e)) for e in bl._ENGINES]
    for name, call in calls:
        counts = []
        for a, b in (small, large):
            call(a, b)
            counts.append(_host_syncs(lambda: call(a, b)))
        assert counts[0] == counts[1], (name, counts)
    monkeypatch.setattr(bl, "_ALG2_MAX_UNROLL_TILES", 1)
    assert (_host_syncs(lambda: pt.spgemm(*small, alg=2))
            == _host_syncs(lambda: pt.spgemm(*large, alg=2)))


@pytest.mark.gpu
def test_group_device_structure_peak_on_card(dev):
    """At 1024^2/0.1, cf 0.2 one staging group holds all 8 tiles: the
    group engine sizing its output from the staged mask peaks no higher
    over one call (max_memory_allocated) than the host-structure path at
    the same G, and gives its bits.  It frees the value stripe before it
    allocates the output's columns; allocating both of the output's
    arrays beside both stripes would peak above the host path."""
    from spmm_tpu_torch.ops import spgemm_blocked as bl

    n = 1024
    a = pt.random(n, n, 0.1, format="csr", seed=31, device=dev)
    b = pt.random(n, n, 0.1, format="csr", seed=32, device=dev)
    n_b, P, _, m_pad, T = bl._alg3_grid(n, n, 0.2)
    host = [x.cpu().numpy() for x in (a.indptr, a.indices, b.indptr,
                                      b.indices)]
    G = bl._GROUP_STAGING_BYTES // (bl.TILE * n * 5)
    assert G >= T == 8

    def peak(fn):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    on_card, c = peak(lambda: bl.spgemm_alg3_blocked(a, b, 1.0, 0.2,
                                                     engine="group"))
    on_host, want = peak(lambda: bl._alg3_group_host(
        a, b, host, 1.0, n_b, P, T, T, m_pad, False, "highest"))
    assert on_card <= on_host, (on_card, on_host)
    _bitwise_csr(c, want)


# ---------------------------------------------------------------------------
# the containers slice: bsr_spmm, csr_densify_mxu, the in-order sum
# ---------------------------------------------------------------------------


def _bsr_on(dev, m, n, density, blocksize, seed):
    a = pt.random(m, n, density, format="csr", seed=seed, device=dev)
    return a, a.tobsr(blocksize=blocksize)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,density,blocksize,k", [
    (64, 256, 0.05, (8, 128), 128),
    (64, 256, 0.05, (16, 128), 128),
    (40, 200, 0.1, (8, 128), 70),     # ragged K and N: the kernel masks
    (37, 260, 0.05, (2, 2), 33),
    (300, 300, 0.05, (130, 3), 65),   # R past one 128-row chunk
    (512, 512, 0.3, (128, 128), 256),
])
def test_bsr_spmm_kernel_vs_plain(dev, m, n, density, blocksize, k):
    from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain

    a, ab = _bsr_on(dev, m, n, density, blocksize, seed=m + n)
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (n, k)).astype(np.float32)).to(dev)
    args = (ab.indptr, ab.indices, ab.data, b, m)
    before = _build.LAUNCHES["bsr_spmm"]
    got = bsr_spmm(*args)
    assert _build.LAUNCHES["bsr_spmm"] == before + 1
    want = bsr_spmm_plain(*args)
    # two float32 orders of the same sums: within 1e-6 of each entry's
    # absolute sum (|A| @ |B|), and bitwise on rerun
    scale = bsr_spmm_plain(ab.indptr, ab.indices, ab.data.abs(), b.abs(), m)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-6 * scale).all())
    assert_bitwise(bsr_spmm(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [8, 64, 128, 256])
@pytest.mark.parametrize("inputs", ["blocks N=200", "csr N=100",
                                    "csr N=70"])
def test_bsr_spmm_tensor_core_tiles(dev, R, inputs):
    """C = 128 at every tile height the kernel picks, N not a multiple of
    the tile (16-byte staging at N = 200 and 100, 4-byte at 70), ragged K
    and m for the CSR inputs; within 1e-6 (|A| @ |X|)_ij of the plain
    version and of float64, bitwise on rerun."""
    from spmm_tpu_torch.models import block_sparse
    from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain

    kind, n_cols = inputs.split(" N=")
    if kind == "blocks":  # dense U[0,1) blocks, 3.5 block rows
        m, k = 3 * R + R // 2, 512
        ab = block_sparse(m, k, (R, 128), 0.5, seed=R, device=dev).tobsr(
            (R, 128))
    else:
        m, k = 3 * R + 5, 293
        ab = pt.random(m, k, 0.05, format="csr", seed=R,
                       device=dev).tobsr((R, 128))
    x = torch.from_numpy(np.random.default_rng(R).standard_normal(
        (k, int(n_cols))).astype(np.float32)).to(dev)
    args = (ab.indptr, ab.indices, ab.data, x, m)
    before = _build.LAUNCHES["bsr_spmm"]
    got = bsr_spmm(*args)
    assert _build.LAUNCHES["bsr_spmm"] == before + 1
    want = bsr_spmm_plain(*args)
    scale = bsr_spmm_plain(ab.indptr, ab.indices, ab.data.abs(), x.abs(), m)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-6 * scale).all())
    s = ab.to_scipy().astype(np.float64)
    xh = x.cpu().double().numpy()
    err = np.abs(got.cpu().double().numpy() - s @ xh)
    assert (err <= 1e-6 * (abs(s) @ np.abs(xh)) + 1e-30).all()
    assert_bitwise(bsr_spmm(*args), got)


def _as_kernel_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in `dtype`; int32 takes round(8 x), so the values are not all 0."""
    if dtype == torch.int32:
        return (x * 8).round().to(dtype)
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("m,n,density,blocksize,k", [
    (64, 256, 0.05, (8, 128), 128),
    (40, 200, 0.1, (8, 128), 70),     # ragged K and N
    (300, 300, 0.05, (130, 3), 65),   # tall blocks, narrow ones
])
def test_bsr_spmm_fma_kernel_vs_plain(dev, dtype, m, n, density, blocksize,
                                      k):
    """The FMA kernel of the other dtypes, launched by `bsr_spmm` and by
    spmm(via="bsr_pallas"), against the plain version of the same inputs
    (on the CPU, where torch multiplies int32): bitwise for int32, within
    1e-12 (float64) or 2^-6 (bfloat16, 4 ulps) of each entry's absolute
    sum (|A| @ |B|), and bitwise on rerun."""
    from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain

    _, ab = _bsr_on(dev, m, n, density, blocksize, seed=m + n)
    ab = ab._with_data(_as_kernel_dtype(ab.data, dtype))
    b = _as_kernel_dtype(torch.from_numpy(np.random.default_rng(
        k).standard_normal((n, k)).astype(np.float32)).to(dev), dtype)
    args = (ab.indptr, ab.indices, ab.data, b, m)
    before = _build.LAUNCHES["bsr_spmm"]
    got = bsr_spmm(*args)
    assert _build.LAUNCHES["bsr_spmm"] == before + 1
    assert got.dtype == dtype and got.shape == (m, k)
    host = [t.cpu() for t in args[:4]]
    want = bsr_spmm_plain(*host, m)
    if dtype == torch.int32:
        assert_bitwise(got.cpu(), want)
    else:
        scale = bsr_spmm_plain(*host[:2], host[2].double().abs(),
                               host[3].double().abs(), m)
        rel = 2.0**-6 if dtype == torch.bfloat16 else 1e-12
        assert bool(((got.cpu().double() - want.double()).abs()
                     <= rel * scale).all())
    assert_bitwise(bsr_spmm(*args), got)
    y = pt.spmm(ab, b, via="bsr_pallas")
    assert _build.LAUNCHES["bsr_spmm"] == before + 3
    assert_bitwise(y, got)


@pytest.mark.gpu
def test_bsr_spmm_other_dtypes_raise_on_card(dev):
    """complex raises as JAX's kernel does; a dtype the kernel has no
    instance for raises on the card rather than run the plain version."""
    from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm

    ab = pt.random(16, 256, 0.05, format="csr", seed=1,
                   device=dev).tobsr()
    for dtype in (torch.complex64, torch.float16):
        with pytest.raises(NotImplementedError, match=str(dtype)):
            bsr_spmm(ab.indptr, ab.indices, ab.data.to(dtype),
                     torch.ones(256, 8, dtype=dtype, device=dev), 16)


@pytest.mark.gpu
def test_bsr_spmm_empty_launches_nothing(dev):
    from spmm_tpu_torch.ops.kernels.bsr_spmm import spmm_bsr

    ab = pt.CSR((16, 256), device=dev).tobsr()
    before = dict(_build.LAUNCHES)
    out = spmm_bsr(ab, torch.ones(256, 8, device=dev))
    assert _build.LAUNCHES == before
    assert out.shape == (16, 8) and not out.any()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,density", [
    (1024, 1024, 0.1), (100, 130, 0.15), (300, 257, 0.05),
    (33, 2000, 0.3), (5000, 12, 0.2)])
def test_densify_mxu_kernel_bitwise_vs_plain(dev, m, k, density):
    from spmm_tpu_torch.ops.kernels.densify_mxu import (
        csr_densify_mxu, csr_densify_mxu_plain)

    a = pt.random(m, k, density, format="csr", seed=m, device=dev)
    args = (a.indptr, a.indices, a.data, m, k)
    before = _build.LAUNCHES["csr_densify_mxu"]
    got = csr_densify_mxu(*args)
    assert _build.LAUNCHES["csr_densify_mxu"] == before + 1
    torch.cuda.synchronize()
    assert_bitwise(got, csr_densify_mxu_plain(*args))
    assert_bitwise(got, a.toarray())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["csr", "bsr", "coo"])
def test_spmm_bsr_routes_on_card_vs_scipy(dev, fmt):
    a = pt.random(256, 384, 0.03, format=fmt, seed=5, device=dev)
    x = np.random.default_rng(6).standard_normal((384, 40)).astype(
        np.float32)
    s = a.to_scipy().astype(np.float64)
    want = s @ x.astype(np.float64)
    scale = abs(s) @ np.abs(x).astype(np.float64)
    before = _build.LAUNCHES["bsr_spmm"]
    for got in (pt.spmm(a, x, via="bsr_pallas"), pt.spmm(a, x, via="bsr"),
                a.tobsr() @ torch.from_numpy(x).to(dev)):
        err = np.abs(got.cpu().double().numpy() - want)
        assert (err <= 1e-6 * scale + 1e-30).all()
    assert _build.LAUNCHES["bsr_spmm"] == before + 1


@pytest.mark.gpu
def test_in_order_sum_on_card_bitwise_vs_cpu(dev):
    from spmm_tpu_torch.ops import _primitives as prim
    from torch_port_helpers import coo_arrays

    rng = np.random.default_rng(3)
    vals = rng.standard_normal((5000, 7)).astype(np.float32)
    lengths = rng.integers(0, 9, 800)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    for v in (vals[:, 0], vals):
        args = (torch.from_numpy(v), torch.from_numpy(starts),
                torch.from_numpy(lengths))
        want = prim.segment_sum_inorder(*args)
        got = prim.segment_sum_inorder(*(t.to(dev) for t in args))
        assert_bitwise(got, want)
    row, col, data = coo_arrays(60, 50, 0.4, 2)
    row, col = row % 7, col % 5  # runs of up to dozens of duplicates
    want = pt.COO((data, (row, col)), shape=(60, 50), device="cpu")
    got = pt.COO((data, (row, col)), shape=(60, 50), device=dev)
    for g, w in ((got.sum_duplicates(), want.sum_duplicates()),
                 (got.tocsr(), want.tocsr()), (got.tocsc(), want.tocsc())):
        for name in ("data", "indices" if g.format != "coo" else "row"):
            assert_bitwise(getattr(g, name), getattr(w, name))
    assert_bitwise(got.sum(axis=0), want.sum(axis=0))


@pytest.mark.gpu
def test_new_formats_default_to_the_card(dev):
    from spmm_tpu_torch.models import banded, block_sparse, uniform

    dense = np.eye(6, 8, dtype=np.float32)
    row, col = np.array([0, 1]), np.array([1, 2])
    data = np.array([1.0, 2.0], np.float32)
    made = [pt.COO((data, (row, col)), shape=(4, 4)), pt.COO(dense),
            pt.CSC(dense), pt.CSR(dense), pt.CSR((3, 3)), pt.BSR(
                pt.CSR(dense), blocksize=(2, 4)),
            pt.DIA((dense[:2], [0, 1]), shape=(6, 8)), pt.eye(5),
            pt.identity(4, format="csr"), pt.diags([data], [1]),
            pt.spdiags(dense[:2], [0, 1], 6, 8)]
    made += [pt.random(20, 20, 0.2, format=f) for f in
             ("coo", "csr", "csc", "bsr", "dia")]
    made += [block_sparse(64, 64, (8, 8), 0.2), banded(10, 10, 1),
             uniform(10, 10, 0.3)]
    for a in made:
        assert a.device == dev, a
    # tensors keep their device
    assert pt.COO((torch.from_numpy(data), (row, col)),
                  shape=(4, 4)).device == torch.device("cpu")


# -- element widths, precision modes, indexing -----------------------------

WIDTH_DTYPES = [torch.bfloat16, torch.float32, torch.float64,
                torch.complex64, torch.complex128]


def _values_of(dtype, n, seed, dev):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal(2 * n))
    v = torch.complex(v[:n], v[n:]) if dtype.is_complex else v[:n]
    v = v.to(dtype)
    if n:
        v[0] = -0.0  # a stored -0.0 moves as it is
    return v.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", WIDTH_DTYPES, ids=str)
@pytest.mark.parametrize("m,k,density", [
    (33, 45, 0.3), (3000, 7, 0.5),
    # rows across the 1024-, 2048- and 4096-cell windows of 16, 8 and
    # 2-or-4-byte values, and k at their edges
    (5, 1023, 0.1), (3, 1025, 0.2), (2, 2047, 0.1), (2, 2049, 0.1),
    (5, 4097, 0.05), (1, 9001, 0.1), (4096, 1, 0.5),
])
@pytest.mark.parametrize("with_pattern", [True, False])
def test_densify_every_width_bitwise_vs_plain(dev, dtype, m, k, density,
                                              with_pattern):
    indptr, indices, data = csr_arrays(m, k, density, seed=m + k, zeros=2,
                                       empty_rows=(m // 2,) if m > 1 else ())
    ip, ix = _on(dev, indptr, indices)
    vals = _values_of(dtype, data.size, m * k, dev)
    before = _build.LAUNCHES["densify_onehot"]
    got = densify_onehot(ip, ix, vals, m, k, with_pattern=with_pattern)
    again = densify_onehot(ip, ix, vals, m, k, with_pattern=with_pattern)
    assert _build.LAUNCHES["densify_onehot"] == before + 2
    want = densify_onehot_plain(ip, ix, vals, m, k, with_pattern)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    for x, y, z in zip(got, want, again):
        if y is None:
            assert x is None and z is None
            continue
        assert_bitwise(x, y)
        assert_bitwise(z, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", WIDTH_DTYPES, ids=str)
@pytest.mark.parametrize("name", ["headline", "mostly_holes", "wide_rows",
                                  "n1", "n17", "m1", "all_false",
                                  "all_true"])
def test_extract_every_width_bitwise_vs_plain(dev, dtype, name, tiles):
    c, mask, nnz = _extract_case(name)
    c = _values_of(dtype, c.size, c.size, dev).view(c.shape) \
        * torch.from_numpy(mask).to(dev)
    (mask,) = _on(dev, mask)
    for cap in (nnz, nnz + 5, nnz + 40_000, max(nnz - 5, 0), 0):
        before = _build.LAUNCHES["extract_roll"]
        got = extract_roll(c, mask, cap)
        again = extract_roll(c, mask, cap)
        assert _build.LAUNCHES["extract_roll"] == before + 2
        want = extract_roll_plain(c, mask, cap)
        torch.cuda.synchronize()
        assert got[2].dtype == dtype
        for x, y, z in zip(got, want, again):
            assert_bitwise(x, y)
            assert_bitwise(z, x)


def _gate_ratio(c, ref):
    """max |c - ref| / (1e-6 |ref| + 1e-6 max|ref|): the gate of "highest"
    passes at <= 1."""
    ref = ref.double()
    tol = 1e-6 * ref.abs() + 1e-6 * ref.abs().max()
    return float(((c.double() - ref).abs() / tol).max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "normal"])
def test_precision_modes_on_card(dev, kind):
    """The value GEMM in each mode against the float64 product: "highest"
    within the 1e-6 gate everywhere; the 3xTF32 "high" within it on a
    SpGEMM cell's kind of operands (U[0,1) values at density 0.1), and on
    dense N(0,1) operands (K = 1024) at least 50x closer than one TF32
    pass, not within it: there the tensor cores' float32 accumulators over
    the whole K lose bits the IEEE GEMM keeps (1.66x the gate measured on
    an H100); one TF32 pass ("default") far outside the gate on both.  The
    global TF32 setting is as it was after each."""
    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    rng = np.random.default_rng(5)
    shape_a, shape_b = (1024, 1024), (1024, 768)
    if kind == "uniform":
        a = rng.random(shape_a) * (rng.random(shape_a) < 0.1)
        b = rng.random(shape_b) * (rng.random(shape_b) < 0.1)
    else:
        a = rng.standard_normal(shape_a)
        b = rng.standard_normal(shape_b)
    a, b = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (a, b))
    ref = a.double() @ b.double()
    before = torch.backends.cuda.matmul.fp32_precision
    ratios = {mode: _gate_ratio(sg._value_matmul(a, b, mode), ref)
              for mode in ("highest", "high", "default")}
    assert torch.backends.cuda.matmul.fp32_precision == before
    assert ratios["highest"] <= 1.0, ratios
    if kind == "uniform":
        assert ratios["high"] <= 1.0, ratios
    else:
        assert ratios["high"] * 50 <= ratios["default"], ratios
    assert ratios["default"] > 10.0, ratios


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["alg1", "alg2", "alg3", "plan"])
def test_high_precision_spgemm_on_card(dev, path):
    """spgemm and a serving plan in "high" at the 1e-6 gate of scipy."""
    a = pt.random(384, 320, 0.1, format="csr", seed=51, device=dev)
    b = pt.random(320, 352, 0.1, format="csr", seed=52, device=dev)
    if path == "plan":
        c = pt.spgemm_plan(a, b, precision="high")(a.data, b.data)
    else:
        c = pt.spgemm(a, b, alg={"alg1": 1, "alg2": 2, "alg3": 3}[path],
                      impl="dense", precision="high")
    _scipy_check(a, b, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64,
                                   torch.complex128, torch.bfloat16])
@pytest.mark.parametrize("alg", [1, 2, 3])
def test_wide_spgemm_on_card_vs_cpu(dev, dtype, alg):
    """alg1 and the blocked engines in each dtype on the card: the
    structure bitwise the CPU's, the values within the JAX dtype tests'
    tolerance of it (bf16: 2 bf16 ulps of the product rounded once), the
    densify and extract kernels launched."""
    a = pt.random(200, 150, 0.1, format="csr", seed=61, device="cpu")
    b = pt.random(150, 170, 0.1, format="csr", seed=62, device="cpu")
    if dtype.is_complex:
        a = a._with_data(torch.complex(a.data, a.data.flip(0)).to(dtype))
        b = b._with_data(torch.complex(b.data.flip(0), b.data).to(dtype))
    else:
        a, b = a.astype(dtype), b.astype(dtype)
    want = pt.spgemm(a, b, alg=alg, impl="dense")
    _build.reset_launches()
    got = pt.spgemm(a.to(dev), b.to(dev), alg=alg, impl="dense")
    assert _build.LAUNCHES["densify_onehot"] >= 1
    assert _build.LAUNCHES["extract_roll"] >= 1
    assert got.dtype == dtype
    assert_bitwise(got.indptr, want.indptr)
    assert_bitwise(got.indices, want.indices)
    g, w = got.data.cpu(), want.data
    if dtype == torch.bfloat16:
        g, w = g.float(), w.float()
        assert bool(((g - w).abs() <= 2 * 2.0 ** -8 * w.abs()).all())
        return
    tol = 1e-12 if dtype in (torch.float64, torch.complex128) else 1e-5
    assert float((g - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.gpu
def test_wide_spmv_spmm_on_card_bitwise_vs_cpu(dev):
    """float64 and complex128 SpMV / SpMM by JAX's gather-and-sum path: the
    in-order segment sum on the card, bitwise the CPU's."""
    for dtype in (torch.float64, torch.complex128):
        a = pt.random(300, 250, 0.05, format="csr", seed=7,
                      dtype=torch.float64, device="cpu").astype(dtype)
        x = _values_of(dtype, 250, 1, "cpu")
        X = _values_of(dtype, 250 * 9, 2, "cpu").view(250, 9)
        ad = a.to(dev)
        _build.reset_launches()
        y, Y = pt.spmv(ad, x.to(dev)), pt.spmm(ad, X.to(dev))
        assert _build.LAUNCHES["segment_sum"] == 2
        assert_bitwise(y, pt.spmv(a, x))
        assert_bitwise(Y, pt.spmm(a, X))


INDEX_KEYS = [
    ("row slice", slice(100, 2900)),
    ("row array", np.arange(3999, 0, -3)),
    ("column slice", (slice(None), slice(1000, 3100))),
    ("every 7th column", (slice(None), np.arange(0, 4000, 7))),
    ("boolean rows", np.arange(4000) % 5 == 2),
    ("pairs", (np.arange(0, 4000, 2), np.arange(3999, 0, -2))),
    ("mesh", np.ix_(np.arange(5, 400, 9), np.arange(3, 4000, 11))),
    ("element", (17, 2213)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,key", INDEX_KEYS, ids=[k[0] for k in
                                                     INDEX_KEYS])
def test_indexing_on_card_bitwise_vs_cpu(dev, name, key):
    a = pt.random(4000, 4000, 0.01, format="csr", seed=71, device="cpu")
    got, want = a.to(dev)[key], a[key]
    if isinstance(want, torch.Tensor):
        assert got.device == dev
        assert_bitwise(got, want)
        return
    assert got.device == dev
    assert got.has_canonical_format == want.has_canonical_format
    assert tuple(got.shape) == tuple(want.shape)
    _bitwise_csr(got, want)


@pytest.mark.gpu
def test_assignment_on_card_bitwise_vs_cpu(dev):
    a = pt.random(3000, 2000, 0.01, format="csr", seed=72, device="cpu")
    b = pt.random(40, 70, 0.2, format="csr", seed=73, device="cpu")
    g = a.to(dev)
    for m, bb in ((a, b), (g, b.to(dev))):
        m[100:140, 500:570] = bb
        m[np.arange(0, 3000, 7)] = 1.25
        m.setdiag(2.5, k=3)
        m[np.array([7, 9, 7]), np.array([1, 1, 1])] = np.array(
            [1.0, 2.0, 3.0], np.float32)
    assert g.device == dev
    _bitwise_csr(g, a)


@pytest.mark.gpu
def test_dia_from_parts_of_host_arrays_on_card(dev):
    data = np.arange(18, dtype=np.float64).reshape(2, 9)
    d = pt.DIA.from_parts(data, [0, 2], (8, 9))
    assert d.device == dev and d.dtype == torch.float32
    cpu = pt.DIA.from_parts(data, [0, 2], (8, 9), device="cpu")
    assert_bitwise(d.toarray(), cpu.toarray())


# ---------------------------------------------------------------------------
# slice 12: the profiler, the headline's graph capture, sddmm and io
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_profile_op_delta_peak_of_a_known_allocation(dev):
    from spmm_tpu_torch.utils.profiler import profile_op, repeat_op

    nbytes = 64 * 2**20
    r = profile_op("alloc", lambda: torch.empty(nbytes, dtype=torch.uint8,
                                                device=dev))
    assert nbytes <= r.delta_hbm_bytes <= nbytes + 2**20
    assert r.peak_hbm_bytes >= r.delta_hbm_bytes and r.time_ms >= 0
    assert r.out_shape == (nbytes,)
    r = repeat_op("alloc", lambda: torch.ones(2**20, device=dev), runs=3)
    assert len(r.times_ms) == 3
    assert 4 * 2**20 <= r.delta_hbm_bytes <= 5 * 2**20


@pytest.mark.gpu
def test_repeat_op_skips_a_real_out_of_memory(dev, capsys):
    from spmm_tpu_torch.utils.profiler import repeat_op

    total = torch.cuda.get_device_properties(dev).total_memory
    assert repeat_op("huge", lambda: torch.empty(2 * total, dtype=torch.uint8,
                                                 device=dev)) is None
    assert capsys.readouterr().out.startswith("[SKIP] huge: OutOfMemoryError")


@pytest.mark.gpu
@pytest.mark.parametrize("n,density", [(256, 0.1), (300, 0.05)])
def test_alg1_fixed_graph_capture_bitwise_eager(dev, n, density):
    from spmm_tpu_torch import bench

    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    a = pt.random(n, n, density, format="csr", seed=n, device=dev)
    b = pt.random(n, n, density, format="csr", seed=n + 1, device=dev)
    cap = int(sg._alg1_dense_compute(a, b, 1.0)[2])
    graph, out = bench.capture(lambda: sg._alg1_fixed(a, b, 1.0, cap))
    graph.replay()
    graph.replay()
    eager = sg._alg1_fixed(a, b, 1.0, cap)
    torch.cuda.synchronize()
    assert bench.same_outputs(out, eager)
    ref = pt.spgemm(a, b, alg=1)
    _bitwise_csr(pt.CSR._wrap(out[0], out[1], out[2], (n, n),
                              canonical=True), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sddmm_on_card(dev, fmt):
    s_cpu = pt.random(500, 400, 0.02, format=fmt, seed=5, device="cpu")
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((500, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 400)).astype(np.float32))
    s = s_cpu.to(dev)
    got = pt.sddmm(s, a.to(dev), b.to(dev), alpha=0.5)
    again = pt.sddmm(s, a.to(dev), b.to(dev), alpha=0.5)
    want = pt.sddmm(s_cpu, a, b, alpha=0.5)
    assert got.device == dev and got.format == fmt
    assert_bitwise(again.data, got.data)
    gate = pt.sddmm(abs(s_cpu).astype(torch.float64), a.abs().double(),
                    b.abs().double(), alpha=0.5)
    for name in {"csr": ("indptr", "indices"), "csc": ("indptr", "indices"),
                 "coo": ("row", "col")}[fmt]:
        assert_bitwise(getattr(got, name), getattr(want, name))
    err = (got.data.cpu().double() - want.data.double()).abs()
    assert bool((err <= 2e-6 * gate.data).all())


@pytest.mark.gpu
@pytest.mark.parametrize("effort", ["auto", "fast"])
def test_spmv_plans_loaded_onto_the_card(dev, tmp_path, effort):
    from spmm_tpu_torch.sparse import io

    a = pt.random(3000, 2500, 0.01, format="csr", seed=7, device=dev)
    x = torch.randn(2500, device=dev)
    plan = pt.spmv_plan(a, effort=effort)
    path = str(tmp_path / "plan.npz")
    io.save_spmv_plan(path, plan)
    loaded = io.load_spmv_plan(path)
    assert loaded[0] == plan[0]
    assert all(t.device == dev for t in loaded[1]
               if isinstance(t, torch.Tensor))
    want = pt.spmv(a, x, plan=plan)
    for _ in range(2):
        assert_bitwise(pt.spmv(a, x, plan=loaded), want)
    assert not loaded[1].counters.any()


@pytest.mark.gpu
def test_csr_loaders_default_to_the_card(dev, tmp_path):
    from spmm_tpu_torch.sparse import io

    a = pt.random(70, 90, 0.1, format="csr", seed=8, device=dev)
    prefix = str(tmp_path / "m")
    io.save_csr_txt(prefix, a)
    io.save_npz(prefix + ".npz", a)
    for back in (io.load_csr_txt(prefix), io.load_npz(prefix + ".npz")):
        assert back.device == dev
        _bitwise_csr(back, a)
    assert io.load_npz(prefix + ".npz", device="cpu").device.type == "cpu"


@pytest.mark.gpu
def test_alg_comparison_cell_on_card(dev):
    """One cell of the speed driver on the card: every alg's row has a
    positive ΔPeak, fresh-call peak, busy time and time, and the three
    products agree (one structure, bitwise; values within 1e-6)."""
    from spmm_tpu_torch.benchmarks import alg_comparison

    rows = alg_comparison.main(["--size", "256", "--density", "0.1",
                                "--runs", "2", "--warmup", "1",
                                "--busy-calls", "1", "--memory",
                                "--device-loop"])
    assert [r["alg"] for r in rows] == [1, 2, 3]
    assert rows[0]["serving_ms"] > 0  # alg1 as one CUDA graph
    for r in rows:
        for key in ("median_ms", "per_call_ms", "delta_hbm_bytes",
                    "peak_hbm_bytes", "busy_ms", "cusparse_ms"):
            assert r[key] > 0, (key, r)
    a, b = alg_comparison.operands(256, 0.1, 2008, dev)
    cs = alg_comparison.products(a, b, (1, 2, 3), 0.2)
    want = cs[1].data.double()
    atol = 1e-6 * float(want.abs().max())
    for c in cs.values():
        assert torch.equal(c.indptr, cs[1].indptr)
        assert torch.equal(c.indices, cs[1].indices)
        assert ((c.data.double() - want).abs()
                <= 1e-6 * want.abs() + atol).all()


@pytest.mark.gpu
def test_numerical_error_within_gate_on_card(dev):
    from spmm_tpu_torch.experiments import numerical_error

    rows = numerical_error.main(["error", "--sizes", "128", "256",
                                 "--densities", "0.1", "0.5"])
    assert len(rows) == 4
    for r in rows:
        assert r["max_err"] <= 1e-6 * r["max_abs_c"], r


# ---------------------------------------------------------------------------
# distribution: world size 1 under NCCL on cuda:0 (one card cannot hold
# two NCCL ranks), each sharded op against the port's single-card op
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """(1-D mesh, 1x1 mesh) of one NCCL rank on cuda:0, for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    from spmm_tpu_torch import parallel as pp

    store = tmp_path_factory.mktemp("nccl") / "store"
    dev = pp.init_process_group(store_path=str(store), world_size=1, rank=0)
    try:
        assert dev == torch.device("cuda", 0)
        assert torch.distributed.get_backend() == "nccl"
        yield pp.make_mesh(1), pp.make_mesh_2d(1, 1)
    finally:
        pp.destroy_process_group()


def _close(got, want, rtol=1e-6):
    want = want.double()
    atol = rtol * float(want.abs().max()) if want.numel() else 0.0
    assert ((got.double() - want).abs() <= rtol * want.abs() + atol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_sharded_spmv_spmm_on_card(nccl, balance):
    """spmv_sharded bitwise the CPU's in-order sums and within 1e-6 of
    spmv; spmm_sharded (spmm_routed) and spmv_t_sharded within 1e-6 of
    spmm and spmv(transa=True); the kernels launched."""
    from spmm_tpu_torch import parallel as pp

    mesh, _ = nccl
    dev = mesh.device
    a = pt.random(3000, 2000, 0.01, format="csr", seed=3, device=dev)
    x = torch.rand(2000, device=dev)
    X = torch.rand(2000, 64, device=dev)
    sh = pp.shard_csr(a, mesh, balance=balance)
    _build.reset_launches()
    y = pp.spmv_sharded(sh, x, mesh)
    c = pp.spmm_sharded(sh, X, mesh)
    xt = pp.spmv_t_sharded(sh, torch.rand(3000, device=dev), mesh)
    assert _build.LAUNCHES["segment_sum"] >= 2
    assert _build.LAUNCHES["spmm_routed"] == 1
    cpu = a.to("cpu")
    want_bits = (cpu.data * x.cpu()[cpu.indices.long()])
    rows = cpu.indptr
    from spmm_tpu_torch.ops.kernels.segment_sum import segment_sum_inorder

    assert_bitwise(y, segment_sum_inorder(want_bits, rows[:-1],
                                          rows[1:] - rows[:-1]))
    _close(y, pt.spmv(a, x))
    _close(c, pt.spmm(a, X))
    assert xt.shape == (2000,)
    for got, want in ((pp.unshard_rows(y, 3000, sh.row_bounds, mesh), y),
                      (pp.spmv_sharded(sh, x, mesh), y)):
        assert_bitwise(got, want)


@pytest.mark.gpu
def test_sharded_spmv_t_on_card(nccl):
    from spmm_tpu_torch import parallel as pp

    mesh, _ = nccl
    a = pt.random(1500, 900, 0.02, format="csr", seed=4, device=mesh.device)
    y = torch.rand(1500, device=mesh.device)
    sh = pp.shard_csr(a, mesh)
    got = pp.spmv_t_sharded(sh, y, mesh)
    _close(got, pt.spmv(a, y, transa=True))
    assert_bitwise(pp.spmv_t_sharded(sh, y, mesh), got)


@pytest.mark.gpu
def test_streamed_spmv_on_card(nccl):
    """The streamed SpMV (no hop at D = 1) bitwise its blocked twin and its
    rerun, within 1e-6 of spmv."""
    from spmm_tpu_torch import parallel as pp

    mesh, _ = nccl
    a = pt.random(5000, 7000, 2e-3, format="csr", seed=5,
                  device=mesh.device)
    x = torch.randn(7000, device=mesh.device)
    sh = pp.shard_csr(a, mesh, balance="nnz")
    plan = pp.spmv_stream_plan(sh, mesh)
    xs = pp.shard_vector(x, mesh)
    y = pp.spmv_sharded_streamed(plan, xs, mesh)
    assert_bitwise(y, pp.spmv_sharded_blocked(plan, x, mesh))
    assert_bitwise(y, pp.spmv_sharded_streamed(plan, xs, mesh))
    _close(y, pt.spmv(a, x))


@pytest.mark.gpu
@pytest.mark.parametrize("stream_b", [True, False])
def test_sharded_spgemm_on_card(nccl, stream_b):
    """spgemm_sharded_sparse's structure bitwise alg1's, values within
    1e-6; spgemm_dense_sharded within 1e-6 of alg1's dense product; the
    densify, extract and count kernels launched."""
    from spmm_tpu_torch import parallel as pp

    mesh, _ = nccl
    dev = mesh.device
    a = pt.random(1024, 1024, 0.01, format="csr", seed=6, device=dev)
    b = pt.random(1024, 1024, 0.01, format="csr", seed=7, device=dev)
    want = pt.spgemm(a, b, alg=1)
    ash, bsh = pp.shard_csr(a, mesh), pp.shard_csr(b, mesh)
    _build.reset_launches()
    c = pp.sharded_to_csr(pp.spgemm_sharded_sparse(ash, bsh, mesh,
                                                   stream_b=stream_b))
    dense = pp.spgemm_dense_sharded(ash, b.toarray(), mesh)
    assert _build.LAUNCHES["densify_onehot"] >= 3
    assert _build.LAUNCHES["extract_roll"] == 1
    assert_bitwise(c.indptr, want.indptr)
    assert_bitwise(c.indices, want.indices)
    _close(c.data, want.data)
    _close(dense, want.toarray())


@pytest.mark.gpu
def test_sharded_spgemm_peak_on_card(nccl):
    """The streamed SpGEMM's peak over one call (max_memory_allocated) at
    D = 1: at least its two dense panels (values and counts), at most its
    dense terms (A's rows and their pattern, one B block and its pattern,
    the panels, the count GEMM's bf16 result and its float32 copy, the
    mask) and the output, with 50% to spare."""
    from spmm_tpu_torch import parallel as pp

    mesh, _ = nccl
    n = 1024
    a = pt.random(n, n, 0.01, format="csr", seed=6, device=mesh.device)
    ash = pp.shard_csr(a, mesh)
    bsh = pp.shard_csr(a, mesh)
    pp.spgemm_sharded_sparse(ash, bsh, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c = pp.spgemm_sharded_sparse(ash, bsh, mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    panels = 8 * n * n
    terms = (6 * n * n + 6 * n * n + panels + 6 * n * n + n * n
             + 12 * c.nnz + 4 * (n + 1))
    assert panels <= peak <= 1.5 * terms, (peak, panels, terms)


@pytest.mark.gpu
def test_summa_on_card(nccl):
    """SUMMA on a 1x1 mesh: the dense product within 1e-6 of alg1's, the
    sparse blocks' CSR with alg1's structure."""
    from spmm_tpu_torch import parallel as pp
    from spmm_tpu_torch.parallel import summa

    _, mesh2 = nccl
    dev = mesh2.device
    a = pt.random(768, 512, 0.02, format="csr", seed=8, device=dev)
    b = pt.random(512, 640, 0.02, format="csr", seed=9, device=dev)
    want = pt.spgemm(a, b, alg=1)
    ash = pp.shard_csr(a, mesh2, axis="x")
    for axis in ("x", "y"):
        bsh = pp.shard_csr(b, mesh2, axis=axis)
        c = pp.spgemm_summa(ash, bsh, mesh2)
        _close(c, want.toarray())
        assert_bitwise(summa.unshard_blocks(c, (768, 640), mesh2), c)
    blocks = summa.spgemm_summa_sparse(ash, bsh, mesh2)
    cs = summa.summa_blocks_to_csr(blocks, (768, 640), mesh2)
    # the block compression keeps the dense product's nonzeros, alg1 its
    # structural cells: one set where no product cancels exactly
    nz = want.data != 0
    assert_bitwise(cs.indices, want.indices[nz])
    assert_bitwise(cs.indptr, want.indptr)
    _close(cs.data, want.data[nz])


@pytest.mark.gpu
def test_sparse_collectives_on_card(nccl):
    """The sparse and dense collectives at one rank under NCCL (its
    all_gather, all_to_all, broadcast, scatter and all_reduce): the wire
    round trips, a self pair of ppermute (a local copy: no rank sends to
    itself), scatter and gather, the sums."""
    from spmm_tpu_torch import parallel as pp
    from spmm_tpu_torch.parallel import collectives as pc

    mesh, _ = nccl
    dev = mesh.device
    a = pt.random(40, 30, 0.2, format="csr", seed=10, device=dev)
    parts = pc.pad_csr(a, a.nnz + 5)
    for out in (pc.ppermute_csr(parts, mesh, "rows", [(0, 0)]),
                pc.broadcast_csr(parts, mesh, "rows", root=0),
                pc.scatter_csr([a], mesh, "rows"),
                tuple(t[0] for t in pc.all_to_all_csr(
                    tuple(t[None] for t in parts), mesh, "rows"))):
        back = pc.unpad_csr(*out[:3], int(out[3]), (40, 30))
        for x, y in ((back.indptr, a.indptr), (back.indices, a.indices),
                     (back.data, a.data)):
            assert_bitwise(x, y)
    s = pc.all_reduce_csr(a, mesh, "rows")
    assert_bitwise(s.data, a.data + 0)
    [g] = pc.gather_csr(parts, mesh, "rows", shape=(40, 30))
    assert_bitwise(g.indices, a.indices)
    v = torch.rand(16, 3, device=dev)
    assert_bitwise(pc.psum_dense(v, mesh, "rows"), v)
    assert_bitwise(pc.reduce_scatter_dense(v, mesh, "rows"), v)
    assert pc.barrier(mesh, "rows") is None


@pytest.mark.gpu
def test_rank_past_the_cards_refused(dev):
    """A rank whose cuda:{local_rank} lies past the machine's cards would
    share one: refused with a worded error before NCCL is reached."""
    from spmm_tpu_torch.parallel import mesh as pm

    with pytest.raises(ValueError, match="one card"):
        pm.rank_device(None, local_rank=torch.cuda.device_count())
    assert pm.rank_device(None, local_rank=0) == torch.device("cuda", 0)
