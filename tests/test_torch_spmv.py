"""The port's SpMV/SpMM slice against the JAX package.

Every input is made with numpy from a seed (`torch_port_helpers`) and goes
as the same host arrays through `spmm_tpu` and `spmm_tpu_torch`.  On the CPU
each port kernel runs its plain PyTorch version; the JAX kernels run in
interpret mode, with their plans built by their own `*_plan` functions.
Tolerances are the JAX suite's own for the same functions: 4e-7 of each
row's absolute sum for the kernels (tests/test_spmv_routed.py:148), and
rtol 1e-5, atol 1e-6 (SpMV) / rtol 1e-4, atol 1e-5 (SpMM) for the ops
(tests/test_ops.py).  The CUDA kernels are held against the plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu_torch.models import power_law_rows  # noqa: E402
from spmm_tpu.ops.kernels import spmv_binned as jax_binned  # noqa: E402
from spmm_tpu.ops.kernels import spmv_onehot as jax_onehot  # noqa: E402
from spmm_tpu.ops.kernels import spmv_routed as jax_routed  # noqa: E402
from spmm_tpu_torch.ops import _primitives as prim  # noqa: E402
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels.spmv_binned import (  # noqa: E402
    CLASS_BOUNDS, PIECE, spmv_binned, spmv_binned_plan)
from spmm_tpu_torch.ops.kernels.spmv_onehot import (  # noqa: E402
    spmv_onehot, spmv_onehot_plan)
from spmm_tpu_torch.ops.kernels.spmv_routed import (  # noqa: E402
    spmm_routed, spmv_routed, spmv_routed_plan)
from torch_port_helpers import assert_bitwise, csr_arrays, pair  # noqa: E402

jax_models = importlib.import_module("spmm_tpu.models.matrices")

# (m, n, density, seed, extra arguments of csr_arrays): the shapes of
# tests/test_spmv_routed.py, then empty rows, explicit zeros, and a small
# power-law matrix (built separately, below)
KERNEL_CASES = {
    "300x256": (300, 256, 0.05, 0, {}),
    "1000x1000": (1000, 1000, 0.01, 1, {}),
    "130x1000": (130, 1000, 0.002, 2, {}),
    "64x64": (64, 64, 0.3, 4, {}),
    "129x200_ragged": (129, 200, 0.08, 5, {}),
    "256x20000_wide": (256, 20000, 0.01, 3, {}),
    "empty_rows": (90, 70, 0.1, 6, {"empty_rows": (0, 1, 44, 89)}),
    "explicit_zeros": (80, 60, 0.15, 7, {"zeros": 6}),
    "powerlaw": None,
}


def _arrays(name):
    if name == "powerlaw":
        a = jax_models.power_law_rows(512, 300, 8, seed=3)
        m, n = a.shape
        return (np.array(a.indptr), np.array(a.indices), np.array(a.data),
                m, n)
    m, n, density, seed, kw = KERNEL_CASES[name]
    return (*csr_arrays(m, n, density, seed, **kw), m, n)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _x(n, seed, k=None):
    shape = n if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_kernel_close(got, want, indptr, indices, data, x):
    """The port's kernel and the JAX kernel each within 4e-7 of the row's
    absolute sum (|A| @ |x|)_i of scipy's float64 product: the JAX suite's
    bound for its fixed-order f32 sums (tests/test_spmv_routed.py:148).
    Both sum in a fixed order, each its own, so they are held to the
    reference rather than bitwise to each other."""
    import scipy.sparse as sp

    m = indptr.size - 1
    a64 = sp.csr_matrix((data.astype(np.float64), indices, indptr),
                        shape=(m, x.shape[0]))
    x64 = x.astype(np.float64)
    ref = a64 @ x64
    rowabs = abs(a64) @ np.abs(x64) + 1e-30
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape == ref.shape and got.dtype == np.float32
    assert np.max(np.abs(got - ref) / rowabs, initial=0.0) < 4e-7
    assert np.max(np.abs(want - ref) / rowabs, initial=0.0) < 4e-7


# ---------------------------------------------------------------------------
# each kernel's plain version against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(KERNEL_CASES))
@pytest.mark.parametrize("kernel", ["routed", "binned", "onehot",
                                    "spmm_routed"])
def test_kernel_plain_matches_jax_interpret(kernel, name):
    indptr, indices, data, m, n = _arrays(name)
    ti, tx, td = _t(indptr, indices, data)
    k = 5 if kernel == "spmm_routed" else None
    x = _x(n, seed=m + n, k=k)
    if kernel == "binned":
        jp = jax_binned.spmv_binned_plan(indptr, indices, data, m, n)
        want = jax_binned.spmv_binned(jnp.asarray(x), jp, interpret=True)
        got = spmv_binned(torch.from_numpy(x),
                          spmv_binned_plan(ti, tx, td, m, n))
    elif kernel == "onehot":
        jp = jax_onehot.spmv_onehot_plan(indptr, m, n, ch=256, unroll=2)
        want = jax_onehot.spmv_onehot(
            jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data),
            jnp.asarray(x), m, n, jp, interpret=True)
        got = spmv_onehot(ti, tx, td, torch.from_numpy(x), m, n,
                          spmv_onehot_plan(ti, m, n, ch=256))
    else:
        jp = jax_routed.spmv_routed_plan(indptr, indices, data, m, n)
        # a small cut and chunk, so the shapes here reach the long-row path
        plan = spmv_routed_plan(ti, tx, td, m, n, cut=8, ch=16)
        if kernel == "routed":
            got = spmv_routed(torch.from_numpy(x), plan)
            if jp is None:  # skew the TPU plan rejects: JAX falls back
                jp = jax_binned.spmv_binned_plan(indptr, indices, data, m, n)
                want = jax_binned.spmv_binned(jnp.asarray(x), jp,
                                              interpret=True)
            else:
                want = jax_routed.spmv_routed(jnp.asarray(x), jp,
                                              interpret=True)
        else:
            got = spmm_routed(torch.from_numpy(x), plan)
            if jp is None:  # JAX's spmm without a plan
                want = st.spmm(st.CSR.from_parts(indptr, indices, data,
                                                 (m, n), canonical=True),
                               jnp.asarray(x))
            else:
                want = jax_routed.spmm_routed(jnp.asarray(x), jp,
                                              interpret=True)
    _assert_kernel_close(got, want, indptr, indices, data, x)


@pytest.mark.parametrize("name", ["300x256", "empty_rows", "powerlaw"])
def test_routed_plan_layout(name):
    """Every entry of a slice row lands in exactly one slot of its row's
    lane, in entry order; long rows are tiled by their chunks; dead slots
    carry (0.0, col 0); the slack is slots / nnz."""
    indptr, indices, data, m, n = _arrays(name)
    ti, tx, td = _t(indptr, indices, data)
    p = spmv_routed_plan(ti, tx, td, m, n, cut=8, ch=16)
    lens = np.diff(indptr)
    short = lens <= 8
    assert sorted(p.order.tolist()) == np.flatnonzero(short).tolist()
    assert p.long_rows.tolist() == np.flatnonzero(~short).tolist()
    sp_ = p.slice_ptr.numpy()
    rows = p.slice_rows.numpy()
    for s in range(p.nslices):
        width = (sp_[s + 1] - sp_[s]) // 32
        for lane in range(32):
            r = rows[s * 32 + lane]
            slots = sp_[s] + 32 * np.arange(width) + lane
            cols = p.sell_col.numpy()[slots]
            vals = p.sell_val.numpy()[slots]
            ln = 0 if r < 0 else lens[r]
            if r >= 0:
                lo, hi = indptr[r], indptr[r + 1]
                assert_bitwise(cols[:ln], indices[lo:hi])
                assert_bitwise(vals[:ln], data[lo:hi])
            assert not cols[ln:].any() and not vals[ln:].any()
        lens_s = [lens[r] for r in rows[s * 32:(s + 1) * 32] if r >= 0]
        assert width == max(lens_s)
    cs, ce = p.chunk_start.numpy(), p.chunk_end.numpy()
    cptr = p.long_chunk_ptr.numpy()
    for i, r in enumerate(p.long_rows.tolist()):
        c = slice(cptr[i], cptr[i + 1])
        assert cs[c][0] == indptr[r] and ce[c][-1] == indptr[r + 1]
        assert (ce[c] - cs[c] <= 16).all() and (cs[c][1:] == ce[c][:-1]).all()
    assert p.slots == sp_[-1] + lens[~short].sum()
    assert p.slack == p.slots / max(len(data), 1) and p.slack >= 1.0


@pytest.mark.parametrize("name", ["300x256", "empty_rows", "powerlaw",
                                  "1000x1000"])
@pytest.mark.parametrize("cut,ch", [(8, 16), (256, 512)])
def test_routed_plan_join_state_and_slice_classes(name, cut, ch):
    """The state of the one-launch kernel: a counter per long row, all zero
    when the plan is built; one partial slot per chunk; each chunk's long
    row; the chunks by (first column, chunk id) in `chunk_order`.  The
    slices stored in class order (8, 4, 2, 1 warps, at most COLS columns a
    warp), `classes` counting them.  A sell=False plan carries the chunks
    and their counters alone."""
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    indptr, indices, data, m, n = _arrays(name)
    ti, tx, td = _t(indptr, indices, data)
    p = spmv_routed_plan(ti, tx, td, m, n, cut=cut, ch=ch)
    nlong, nchunks = p.long_rows.numel(), p.chunk_start.numel()
    assert p.counters.dtype == torch.int32 and p.counters.numel() == nlong
    assert not p.counters.any()
    assert p.partial.dtype == torch.float32 and p.partial.numel() == nchunks
    cptr = p.long_chunk_ptr.numpy()
    assert_bitwise(p.chunk_row, np.repeat(np.arange(nlong), np.diff(cptr))
                   .astype(np.int32))
    width = np.diff(p.slice_ptr.numpy()) // 32
    warps = kr.slice_warps(torch.from_numpy(width)).numpy()
    assert sum(p.classes) == p.nslices
    assert warps.tolist() == sorted(warps.tolist(), reverse=True)
    assert list(p.classes) == [int((warps == w).sum()) for w in (8, 4, 2, 1)]
    # the fewest warps that give each at most COLS columns, 8 at the most
    assert ((width <= kr.COLS * warps) | (warps == 8)).all()
    assert ((width > kr.COLS * warps // 2) | (warps == 1)).all()
    first = indices[p.chunk_start.numpy()].astype(np.int64)
    assert_bitwise(p.chunk_order, np.lexsort((np.arange(first.size), first))
                   .astype(np.int32))
    q = spmv_routed_plan(ti, tx, td, m, n, cut=cut, ch=ch, sell=False)
    assert q.partial is None and q.slice_ptr is None
    assert q.counters.dtype == torch.int32 and q.counters.numel() == nlong
    assert not q.counters.any()
    for name in ("chunk_row", "chunk_order"):
        assert_bitwise(getattr(q, name), getattr(p, name))


def _plan_tensors(plan):
    """A plan's tensors, but its scratch (`partial`, never read before a
    launch writes it)."""
    return {k: v for k, v in plan._asdict().items()
            if isinstance(v, torch.Tensor) and k != "partial"}


@pytest.mark.parametrize("name", ["300x256", "empty_rows", "powerlaw"])
@pytest.mark.parametrize("kind", ["routed", "binned"])
def test_plan_of_host_arrays_on_cpu(kind, name, monkeypatch):
    """The plan functions take host arrays as JAX's do (float64 values
    converted to float32): with device="cpu" the plan is the tensor CSR's,
    bitwise, and its SpMV and SpMM agree with the tensor plan's and with
    JAX's; a host array's plan goes to the card by default, so without one
    it raises rather than fall back to the CPU."""
    indptr, indices, data, m, n = _arrays(name)
    ti, tx, td = _t(indptr, indices, data)
    x = _x(n, seed=m + 3)
    xt = torch.from_numpy(x)
    if kind == "routed":
        kw = dict(cut=8, ch=16)
        host = spmv_routed_plan(indptr, indices, data.astype(np.float64), m,
                                n, device="cpu", **kw)
        tens = spmv_routed_plan(ti, tx, td, m, n, **kw)
        got, want = spmv_routed(xt, host), spmv_routed(xt, tens)
        X = torch.from_numpy(_x(n, seed=m + 4, k=6))
        assert_bitwise(spmm_routed(X, host), spmm_routed(X, tens))
        jp = jax_routed.spmv_routed_plan(indptr, indices, data, m, n)
        jax_y = (jax_routed.spmv_routed(jnp.asarray(x), jp, interpret=True)
                 if jp is not None else None)
        build = lambda: spmv_routed_plan(  # noqa: E731
            indptr, indices, data, m, n)
    else:
        host = spmv_binned_plan(indptr, indices, data.astype(np.float64), m,
                                n, device="cpu")
        tens = spmv_binned_plan(ti, tx, td, m, n)
        got, want = spmv_binned(xt, host), spmv_binned(xt, tens)
        jp = jax_binned.spmv_binned_plan(indptr, indices, data, m, n)
        jax_y = (jax_binned.spmv_binned(jnp.asarray(x), jp, interpret=True)
                 if jp is not None else None)
        build = lambda: spmv_binned_plan(  # noqa: E731
            indptr, indices, data, m, n)
    fields = _plan_tensors(tens)
    assert fields.keys() == _plan_tensors(host).keys()
    for key, t in _plan_tensors(host).items():
        assert t.device.type == "cpu", key
        assert_bitwise(t, fields[key])
    assert_bitwise(got, want)
    if jax_y is not None:
        _assert_kernel_close(got, jax_y, indptr, indices, data, x)
    # a tensor's plan moves where `device` says
    assert _plan_tensors(spmv_routed_plan(ti, tx, td, m, n, device="cpu")
                         )["indptr"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def _hub_arrays():
    """A CSR whose rows reach past CLASS_BOUNDS[-1]: rows of 1, 2 and 3
    pieces of PIECE entries between empty and short rows (n = 3 * PIECE)."""
    n = 3 * PIECE
    rng = np.random.default_rng(12)
    lens = np.array([0, 3, PIECE, 0, 2 * PIECE + 5, 70, CLASS_BOUNDS[-1] + 1,
                     3 * PIECE, 1, 0])
    indices = np.concatenate([np.sort(rng.choice(n, ln, replace=False))
                              for ln in lens]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    data = rng.standard_normal(indices.size).astype(np.float32)
    return indptr, indices, data, lens.size, n


@pytest.mark.parametrize("name", ["1000x1000", "empty_rows", "powerlaw",
                                  "hubs"])
def test_binned_plan_partitions_rows_by_length(name):
    indptr, indices, data, m, n = (_hub_arrays() if name == "hubs"
                                   else _arrays(name))
    p = spmv_binned_plan(*_t(indptr, indices, data), m, n)
    off = p.class_off.tolist()
    rows = p.rows.numpy()
    assert sorted(rows.tolist()) == list(range(m)) and off[0] == 0
    assert off[-1] == m
    bounds = (-1, *CLASS_BOUNDS, np.iinfo(np.int32).max)
    lens = np.diff(indptr)
    for c in range(len(off) - 1):
        got = rows[off[c]:off[c + 1]]
        assert (np.diff(got) > 0).all()  # stable: row order kept
        assert ((lens[got] > bounds[c]) & (lens[got] <= bounds[c + 1])).all()
    # the hub pieces: each class-3 row cut into ceil(len / PIECE) pieces,
    # numbered contiguously and in row order; nothing else has a piece
    hubs = rows[off[-2]:]
    pieces = np.where(lens > CLASS_BOUNDS[-1], -(-lens // PIECE), 0)
    assert_bitwise(p.piece_end, np.cumsum(pieces).astype(np.int32))
    total = int(pieces.sum())
    assert p.piece_row.numel() == p.counters.numel() == p.partial.numel()
    assert p.piece_row.numel() >= total
    assert p.piece_row[:total].tolist() == np.repeat(np.arange(m),
                                                     pieces).tolist()
    assert sorted(set(p.piece_row[:total].tolist())) == hubs.tolist()
    # each row's pieces tile it in order: piece k spans
    # [indptr[r] + k*PIECE, min(indptr[r] + (k+1)*PIECE, indptr[r+1]))
    for r in hubs:
        k = np.arange(pieces[r])
        starts = indptr[r] + k * PIECE
        ends = np.minimum(starts + PIECE, indptr[r + 1])
        assert starts[0] == indptr[r] and ends[-1] == indptr[r + 1]
        assert (starts[1:] == ends[:-1]).all() and (ends > starts).all()
    assert not p.counters.any()  # the counters start at zero
    units = (-(-(off[3] - off[2]) // 8) + -(-(off[2] - off[1]) // 32)
             + -(-(off[1] - off[0]) // 256) + total)
    assert units <= p.max_units


@pytest.mark.parametrize("ch", [256, 1024])
def test_onehot_plan_row_windows(ch):
    indptr, _, _, m, n = _arrays("empty_rows")
    p = spmv_onehot_plan(indptr, m, n, ch=ch, device="cpu")
    assert p.own.device.type == "cpu"
    nnz = indptr[-1]
    starts = np.arange(0, nnz, ch)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    assert p.row_s.tolist() == rows[starts].tolist()
    # every row is owned by exactly one chunk: the chunk holding its first
    # entry, and the last chunk also the trailing rows at indptr == nnz
    own = p.own.numpy()
    assert own[0] == 0 and own[-1] == m and (np.diff(own) >= 0).all()
    owner = np.repeat(np.arange(p.nchunks), np.diff(own))
    assert owner.size == m
    want = np.minimum(indptr[:-1] // ch, p.nchunks - 1)
    assert owner.tolist() == want.tolist()
    assert p.counters.tolist() == [0] * p.nchunks
    assert p.carry.numel() == 2 * p.nchunks
    with pytest.raises(ValueError, match="multiple"):
        spmv_onehot_plan(indptr, m, n, ch=100, device="cpu")
    # a tensor's plan lies where the tensor does
    assert spmv_onehot_plan(torch.from_numpy(indptr), m, n,
                            ch=ch).own.device.type == "cpu"


def test_onehot_plan_of_host_array_goes_to_the_card():
    # as the constructors: a host array's plan is made on the card, and
    # raises where there is none
    indptr, _, _, m, n = _arrays("300x256")
    if torch.cuda.is_available():
        assert spmv_onehot_plan(indptr, m, n).own.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spmv_onehot_plan(indptr, m, n)


def test_onehot_plan_of_empty_and_one_row():
    # no entries: one chunk owns every row; m = 1: the chunk owns row 0
    for indptr in (np.zeros(5, np.int32), np.array([0, 700], np.int32)):
        m = indptr.size - 1
        p = spmv_onehot_plan(indptr, m, 9, ch=256, device="cpu")
        assert p.own.tolist()[0] == 0 and p.own.tolist()[-1] == m
        assert p.nchunks == max(1, -(-int(indptr[-1]) // 256))


def test_onehot_call_checks_against_its_plan():
    # the plan is validated when it is built; a call still refuses arrays
    # that do not fit it
    indptr, indices, data, m, n = _arrays("300x256")
    ti, tx, td = _t(indptr, indices, data)
    p = spmv_onehot_plan(ti, m, n, ch=256)
    x = torch.ones(n)
    with pytest.raises(ValueError, match="x has"):
        spmv_onehot(ti, tx, td, torch.ones(n + 1), m, n, p)
    with pytest.raises(ValueError, match="plan is for"):
        spmv_onehot(ti, tx[:-1], td[:-1], x, m, n, p)
    with pytest.raises(ValueError, match="plan is for"):
        spmv_onehot(ti, tx, td, torch.ones(n + 1), m, n + 1, p)
    with pytest.raises(ValueError, match="float32"):
        spmv_onehot(ti, tx, td.double(), x, m, n, p)


@pytest.mark.parametrize("kernel", ["binned", "onehot"])
def test_plain_paths_match_jax_on_hub_rows(kernel):
    # rows of up to 3 pieces among empty and short ones, against the JAX
    # package's spmv of the same arrays
    indptr, indices, data, m, n = _hub_arrays()
    x = _x(n, seed=3)
    ti, tx, td = _t(indptr, indices, data)
    if kernel == "binned":
        got = spmv_binned(torch.from_numpy(x),
                          spmv_binned_plan(ti, tx, td, m, n))
    else:
        got = spmv_onehot(ti, tx, td, torch.from_numpy(x), m, n,
                          spmv_onehot_plan(ti, m, n, ch=1024))
    want = st.spmv(st.CSR.from_parts(indptr, indices, data, (m, n),
                                     canonical=True), jnp.asarray(x))
    _assert_kernel_close(got, want, indptr, indices, data, x)


@pytest.mark.parametrize("kernel", ["routed", "binned", "onehot",
                                    "spmm_routed"])
def test_kernels_take_empty_matrix_and_full_row(kernel):
    # an empty 6x9 matrix gives zeros; one full row of n entries (the
    # power-law family's hub) is summed whole, through the long-row path
    n = 300
    for indptr, indices in (
            (np.zeros(7, np.int32), np.zeros(0, np.int32)),
            (np.array([0, 0, n, n], np.int32), np.arange(n, dtype=np.int32))):
        m = indptr.size - 1
        ncols = 9 if m == 6 else n
        data = np.linspace(-1, 1, indices.size, dtype=np.float32)
        x = _x(ncols, seed=1, k=3 if kernel == "spmm_routed" else None)
        ti, tx, td = _t(indptr, indices, data)
        tv = torch.from_numpy(x)
        if kernel == "binned":
            y = spmv_binned(tv, spmv_binned_plan(ti, tx, td, m, ncols))
        elif kernel == "onehot":
            y = spmv_onehot(ti, tx, td, tv, m, ncols,
                            spmv_onehot_plan(ti, m, ncols))
        else:
            p = spmv_routed_plan(ti, tx, td, m, ncols, cut=32, ch=64)
            y = (spmv_routed(tv, p) if kernel == "routed"
                 else spmm_routed(tv, p))
        ref = (np.zeros((m,) + x.shape[1:]) if indices.size == 0
               else np.stack([np.zeros(x.shape[1:]), data.astype(np.float64)
                              @ x.astype(np.float64), np.zeros(x.shape[1:])]))
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the ops against spmm_tpu: spmv, spmm, the four `@` forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.0, 0.01, 0.1, 0.5])
@pytest.mark.parametrize("shape", [(64, 64), (128, 50), (33, 77)])
@pytest.mark.parametrize("via", ["auto", "csr", "dense"])
def test_spmv_matches_jax(shape, density, via):
    m, n = shape
    a_ref, a = pair(m, n, density, seed=m + n)
    x = np.random.default_rng(1).random(n, dtype=np.float32)
    want = np.asarray(st.spmv(a_ref, jnp.asarray(x), via=via))
    got = pt.spmv(a, x, via=via)
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("via", ["auto", "csr", "dense"])
@pytest.mark.parametrize("transa", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 2.0, -0.5])
def test_spmv_alpha_transa_matches_jax(alpha, transa, via):
    a_ref, a = pair(40, 30, 0.2, seed=0, zeros=2, empty_rows=(3, 17))
    x = np.random.default_rng(1).random(40 if transa else 30,
                                        dtype=np.float32)
    want = np.asarray(st.spmv(a_ref, jnp.asarray(x), alpha=alpha,
                              transa=transa, via=via))
    got = pt.spmv(a, torch.from_numpy(x), alpha=alpha, transa=transa,
                  via=via)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("via", ["csr", "dense"])
@pytest.mark.parametrize("density", [0.01, 0.2])
def test_spmm_matches_jax(via, density):
    a_ref, a = pair(96, 72, density, seed=0)
    b = np.random.default_rng(1).random((72, 33), dtype=np.float32)
    want = np.asarray(st.spmm(a_ref, jnp.asarray(b), via=via))
    got = pt.spmm(a, b, via=via)
    assert got.shape == (96, 33)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("via", ["csr", "dense"])
@pytest.mark.parametrize("transa", [False, True])
@pytest.mark.parametrize("k", [1, 7, 40])
def test_spmm_alpha_transa_matches_jax(k, transa, via):
    a_ref, a = pair(40, 30, 0.2, seed=2, empty_rows=(0, 39))
    b = np.random.default_rng(1).random((40 if transa else 30, k),
                                        dtype=np.float32)
    want = np.asarray(st.spmm(a_ref, jnp.asarray(b), alpha=0.5,
                              transa=transa, via=via))
    got = pt.spmm(a, torch.from_numpy(b), alpha=0.5, transa=transa, via=via)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_spmm_routed_plan_matches_jax():
    # spmm(plan=("routed", p)) as tests/test_spmv_routed.py's
    # test_spmm_plan_dispatch, with the port's own plan
    a_ref, a = pair(120, 90, 0.06, seed=3)
    b = np.random.default_rng(5).standard_normal((90, 4)).astype(np.float32)
    plan = ("routed", spmv_routed_plan(a.indptr, a.indices, a.data, 120, 90,
                                       cut=4, ch=8))
    want = np.asarray(st.spmm(a_ref, jnp.asarray(b)))
    got = pt.spmm(a, b, plan=plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # a tagged plan also drives spmv; the transposed product ignores it
    x = b[:, 0].copy()
    np.testing.assert_allclose(pt.spmv(a, x, plan=plan).numpy(),
                               np.asarray(st.spmv(a_ref, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    bt = np.random.default_rng(6).random((120, 3), dtype=np.float32)
    np.testing.assert_allclose(
        pt.spmm(a, bt, transa=True, plan=plan).numpy(),
        np.asarray(st.spmm(a_ref, jnp.asarray(bt), transa=True)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tag", ["routed", "binned", "onehot", "bare"])
def test_spmv_tagged_plans_match_jax(tag):
    a_ref, a = pair(70, 50, 0.1, seed=4, empty_rows=(2, 69))
    m, n = a.shape
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    if tag == "routed":
        plan = (tag, spmv_routed_plan(a.indptr, a.indices, a.data, m, n,
                                      cut=4, ch=8))
    elif tag == "binned":
        plan = (tag, spmv_binned_plan(a.indptr, a.indices, a.data, m, n))
    else:
        p = spmv_onehot_plan(a.indptr, m, n, ch=256)
        plan = ("onehot", p) if tag == "onehot" else p
    want = np.asarray(st.spmv(a_ref, jnp.asarray(x), alpha=3.0))
    got = pt.spmv(a, x, alpha=3.0, plan=plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["A@x", "A@X", "x@A", "X@A"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_matmul_forms_match_jax(form, as_tensor):
    a_ref, a = pair(45, 35, 0.15, seed=5, zeros=2)
    rng = np.random.default_rng(3)
    shape = {"A@x": (35,), "A@X": (35, 6), "x@A": (45,),
             "X@A": (4, 45)}[form]
    v = rng.standard_normal(shape).astype(np.float32)
    w = torch.from_numpy(v) if as_tensor else v
    if form.startswith("A"):
        want = np.asarray(a_ref @ jnp.asarray(v))
        got = a @ w
    else:
        want = np.asarray(a_ref.__rmatmul__(jnp.asarray(v)))
        got = w @ a
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    tol = dict(rtol=1e-5, atol=1e-6) if v.ndim == 1 else dict(rtol=1e-4,
                                                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_matmul_dense_route_at_break_even():
    # 64x64 at any density is below the 2048 scale: the dense route
    a_ref, a = pair(64, 64, 0.3, seed=6)
    b = np.random.default_rng(4).random((64, 5), dtype=np.float32)
    assert pt.break_even_density(64, 64, 5) == 1.0
    np.testing.assert_allclose(pt.matmul(a, b, mode="dense").numpy(),
                               np.asarray(st.matmul(a_ref, jnp.asarray(b),
                                                    mode="dense")),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt.matmul(a, b, mode="sparse").numpy(),
                               (a.to_scipy() @ b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scale,want", [(1024, 1.0), (2048, 1.0),
                                        (4096, 3e-2), (16384, 1e-2),
                                        (1 << 20, 3e-3)])
def test_break_even_density_is_the_hard_coded_curve(scale, want):
    from spmm_tpu_torch.ops.dispatch import _dense_fits

    assert pt.break_even_density(scale, 8, 8) == want
    assert _dense_fits(1000, 1000, 1000) and not _dense_fits(40000, 40000, 8)


# ---------------------------------------------------------------------------
# validation, plans off the card, determinism, helpers
# ---------------------------------------------------------------------------


def test_spmv_spmm_validation_matches_jax():
    # tests/test_ops.py:53-89, with the same exception types
    a_ref, a = pair(8, 8, 0.5, seed=0)
    cases = [
        (lambda s, m: s.spmv(m, np.ones(4, np.float32)), ValueError),
        (lambda s, m: s.spmv(m, np.ones((8, 2), np.float32)), ValueError),
        (lambda s, m: s.spmv(np.ones((8, 8), np.float32),
                             np.ones(8, np.float32)), TypeError),
        (lambda s, m: s.spmm(m, np.ones((4, 4), np.float32)), ValueError),
        (lambda s, m: s.spmm(m, np.ones(8, np.float32)), ValueError),
        (lambda s, m: s.spmv(m, np.ones(9, np.float32), transa=True),
         ValueError),
    ]
    for call, exc in cases:
        with pytest.raises(exc):
            call(st, a_ref)
        with pytest.raises(exc):
            call(pt, a)
    for mat in (a_ref, a):
        with pytest.raises(ValueError, match="Scalar"):
            mat @ 2.0


def _close64(got, want):
    """float64 values within 1e-12 x max|want| of JAX's."""
    w = np.asarray(want)
    assert got.dtype == torch.float64 and w.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-12 * np.abs(w).max())


def test_port_only_errors():
    _, a = pair(8, 8, 0.5, seed=0)
    x = np.ones(8, np.float32)
    for via in ("binned", "onehot"):  # as JAX off the TPU
        with pytest.raises(ValueError, match="does not apply"):
            pt.spmv(a, x, via=via)
    # float64 operands compute now, as in JAX with x64 (promoted to the
    # common type), on every route, the BSR ones included
    a64 = pt.random(8, 8, 0.5, format="csr", seed=0, dtype=torch.float64,
                    device="cpu")
    x64, X = np.linspace(-1, 1, 8), np.ones((8, 2), np.float32)
    with jax.enable_x64(True):
        a_ref = st.CSR.from_parts(*(np.asarray(t) for t in (
            a.indptr, a.indices, a.data)), (8, 8), canonical=True)
        a64_ref = st.CSR.from_parts(*(t.numpy() for t in (
            a64.indptr, a64.indices, a64.data)), (8, 8), canonical=True)
        y = pt.spmv(a, torch.from_numpy(x64))
        assert y.dtype == torch.float64
        _close64(y, st.spmv(a_ref, jnp.asarray(x64)))
        _close64(pt.spmm(a64, X), st.spmm(a64_ref, jnp.asarray(X)))
        for via in ("bsr", "bsr_pallas"):
            _close64(pt.spmm(a64.tobsr(), X, via=via),
                     st.spmm(a64_ref.tobsr(), jnp.asarray(X), via=via))
    plan = spmv_binned_plan(a.indptr, a.indices, a.data, 8, 8)
    with pytest.raises(ValueError, match="x has"):
        spmv_binned(torch.ones(9), plan)
    p = spmv_routed_plan(a.indptr, a.indices, a.data, 8, 8, sell=False)
    with pytest.raises(ValueError, match="sell=False"):
        spmv_routed(torch.ones(8), p)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_routed(torch.ones(2, 8).T, p)


def test_spmv_plan_is_none_on_cpu():
    # as spmm_tpu's spmv_plan off the TPU (tests/test_spmv_binned.py:80)
    a_ref, a = pair(100, 100, 0.05, seed=3)
    assert st.spmv_plan(a_ref) is None
    for effort in ("auto", "max", "fast"):
        assert pt.spmv_plan(a, effort=effort) is None
    from spmm_tpu_torch.ops.spmv import spmv_onehot_plans

    assert spmv_onehot_plans(a) is None


@pytest.mark.parametrize("path", ["auto", "transa", "dense", "spmm",
                                  "spmm_t", "routed", "onehot"])
def test_rerun_is_bitwise(path):
    _, a = pair(60, 50, 0.1, seed=8)
    x = np.random.default_rng(0).standard_normal(60).astype(np.float32)
    X = np.random.default_rng(1).standard_normal((60, 9)).astype(np.float32)
    plans = {
        "routed": ("routed", spmv_routed_plan(a.indptr, a.indices, a.data,
                                              60, 50, cut=4, ch=8)),
        "onehot": ("onehot", spmv_onehot_plan(a.indptr, 60, 50, ch=256)),
    }
    run = {
        "auto": lambda: pt.spmv(a, x[:50]),
        "transa": lambda: pt.spmv(a, x, transa=True),
        "dense": lambda: pt.spmv(a, x[:50], via="dense"),
        "spmm": lambda: pt.spmm(a, X[:50]),
        "spmm_t": lambda: pt.spmm(a, X, transa=True),
        "routed": lambda: pt.spmv(a, x[:50], plan=plans["routed"]),
        "onehot": lambda: pt.spmv(a, x[:50], plan=plans["onehot"]),
    }[path]
    assert_bitwise(run(), run())


def test_cpu_paths_launch_no_kernel():
    _, a = pair(30, 30, 0.2, seed=9)
    before = dict(_build.LAUNCHES)
    pt.spmv(a, np.ones(30, np.float32), transa=True)
    pt.spmm(a, np.ones((30, 3), np.float32))
    assert _build.LAUNCHES == before


def test_transpose_matches_jax():
    a_ref, a = pair(37, 23, 0.2, seed=10, zeros=3, empty_rows=(0, 5))
    t_ref, t = a_ref.transpose(), a.T
    assert t.shape == (23, 37) and t.has_canonical_format
    assert_bitwise(t.indptr, np.asarray(t_ref.indptr))
    assert_bitwise(t.indices, np.asarray(t_ref.indices))
    assert_bitwise(t.data, np.asarray(t_ref.data))
    ip, ix, dv = prim.csr_transpose(t.indptr, t.indices, t.data, t.shape)
    assert_bitwise(ip, a.indptr)
    assert_bitwise(ix, a.indices)
    assert_bitwise(dv, a.data)


def test_power_law_rows_matches_jax_bitwise():
    ref = jax_models.power_law_rows(3000, 2000, 8, seed=1)
    got = power_law_rows(3000, 2000, 8, seed=1, device="cpu")
    assert got.shape == ref.shape and got.has_canonical_format
    assert_bitwise(got.indptr, np.asarray(ref.indptr))
    assert_bitwise(got.indices, np.asarray(ref.indices))
    assert_bitwise(got.data, np.asarray(ref.data))
