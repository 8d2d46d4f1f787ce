"""CPU emulations of the index arithmetic of the port's one-pass kernels,
against their plain versions and the JAX package.

`csrc/route.cu::expand_routed` writes the flat dense output window by
window from the plan's window table; `route.densify_routed_windows`
repeats that arithmetic on the CPU at any window size.  `csrc/extract.cu`
compacts the flat mask tile by tile with a decoupled look-back scan;
`extract_roll.extract_roll_tiles` repeats the per-tile and per-thread
counts, their scans and indptr from the row starts inside tiles, and
`extract_roll.lookback_prefixes` the look-back itself under random
interleavings.  Each is held bitwise against the plain version and JAX's
Pallas kernel in interpret mode (pure data movement and integer scans:
no tolerance), at window and tile sizes far below the kernels' so that
rows cross many windows and tiles and tiles hold many rows.  Inputs are
made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import spmm_tpu as st  # noqa: E402,F401  (CPU config via conftest)
from spmm_tpu.ops.kernels import route as jax_route  # noqa: E402
from spmm_tpu.ops.kernels.extract_roll import (  # noqa: E402
    extract_roll as jax_extract)
from spmm_tpu_torch.ops.kernels import extract_roll as er  # noqa: E402
from spmm_tpu_torch.ops.kernels import route  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, csr_arrays, masked_dense, unsorted_csr_arrays)


def _flat(indptr, indices, k):
    rows = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    return rows * k + indices.astype(np.int64)


# ---------------------------------------------------------------------------
# expand_routed: the window table and the window-by-window fill
# ---------------------------------------------------------------------------

# (m, k, density): k below, equal to and above the window sizes 8, 64 and
# 4096; m*k a multiple of 128 where JAX's plan applies
EXPAND_CASES = [(128, 128, 0.1), (256, 64, 0.3), (64, 8, 0.5),
                (32, 4096, 0.01), (1, 8192, 0.05), (384, 2, 0.4),
                (37, 45, 0.3), (3, 5000, 0.02)]


@pytest.mark.parametrize("w", [8, 64, 4096])
@pytest.mark.parametrize("m,k,density", EXPAND_CASES)
def test_window_table_bounds_every_entry(w, m, k, density):
    indptr, indices, _ = csr_arrays(m, k, density, seed=m + k)
    pos = _flat(indptr, indices, k)
    table = route.window_table(pos, m * k, w)
    assert table.size == -(-m * k // w) + 1
    assert table[0] == 0 and table[-1] == pos.size
    assert (np.diff(table) >= 0).all()
    win = np.repeat(np.arange(table.size - 1), np.diff(table))
    assert ((pos >= win * w) & (pos < (win + 1) * w)).all()


def _jax_densify(indptr, indices, data, m, k):
    plan = jax_route.expand_route_plan(indptr, indices, m, k)
    if plan is None:  # the TPU gate m*k % 128
        return None
    d, p = jax_route.densify_routed(jnp.asarray(data), plan, interpret=True)
    return np.asarray(d), np.asarray(p)


@pytest.mark.parametrize("w", [8, 64, 4096])
@pytest.mark.parametrize("m,k,density", EXPAND_CASES)
def test_windowed_fill_bitwise_plain_and_jax(w, m, k, density):
    indptr, indices, data = csr_arrays(m, k, density, seed=m + k, zeros=1)
    data[::5] = -0.0
    plan = route.expand_route_plan(indptr, indices, m, k, device="cpu")
    vals = torch.from_numpy(data)
    got = route.densify_routed_windows(vals, plan, w)
    want = route.densify_routed_plain(vals, plan)
    for x, y in zip(got, want):
        assert_bitwise(x, y)
    jax = _jax_densify(indptr, indices, data, m, k)
    if jax is not None:
        for x, y in zip(got, jax):
            assert_bitwise(x, y)
    value_only = route.densify_routed_windows(vals, plan, w,
                                              emit_pattern=False)
    assert_bitwise(value_only, want[0])


@pytest.mark.parametrize("w", [8, 64, 4096])
@pytest.mark.parametrize("m,k", [(128, 256), (64, 130), (256, 384)])
def test_windowed_fill_of_unsorted_structure(w, m, k):
    """Out of order without duplicates: the plan sorts the positions and
    keeps each one's value index; the fill equals the plain version,
    scipy's `toarray()` and JAX's plan of the canonical (sorted) form.
    JAX's own plan assumes a canonical structure (it routes by searchsorted
    over the positions), so it is given the sorted form."""
    indptr, indices, data = unsorted_csr_arrays(m, k, 0.2, seed=m + k,
                                                max_run=1)
    plan = route.expand_route_plan(indptr, indices, m, k, device="cpu")
    assert plan.src is not None
    vals = torch.from_numpy(data)
    got = route.densify_routed_windows(vals, plan, w)
    want = route.densify_routed_plain(vals, plan)
    for x, y in zip(got, want):
        assert_bitwise(x, y)
    assert_bitwise(got[0], sp.csr_matrix((data, indices, indptr),
                                         shape=(m, k)).toarray())
    order = np.argsort(_flat(indptr, indices, k), kind="stable")
    jax = _jax_densify(indptr, indices[order], data[order], m, k)
    if jax is not None:
        for x, y in zip(got, jax):
            assert_bitwise(x, y)


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_duplicate_structure_is_refused(seed):
    """JAX's routing tables leave a duplicate position's value undefined:
    pinned here on structures of duplicates where its dense result is
    neither the one that keeps the first stored value of every duplicated
    cell nor the one that keeps the last.  The port's plan raises for
    every duplicate structure."""
    m, k = 128, 128
    indptr, indices, data = unsorted_csr_arrays(m, k, 0.6, seed=seed,
                                                max_run=2)
    with pytest.raises(ValueError, match="duplicate"):
        route.expand_route_plan(indptr, indices, m, k, device="cpu")
    flat = _flat(indptr, indices, k)
    first = np.zeros(m * k, np.float32)
    last = np.zeros(m * k, np.float32)
    last[flat] = data                   # numpy: the last write lands
    first[flat[::-1]] = data[::-1]
    jd, _ = _jax_densify(indptr, indices, data, m, k)
    assert not np.array_equal(jd.ravel().view(np.uint32),
                              last.view(np.uint32))
    assert not np.array_equal(jd.ravel().view(np.uint32),
                              first.view(np.uint32))


# ---------------------------------------------------------------------------
# extract_roll: per-tile counts, the scan, indptr from row starts in tiles
# ---------------------------------------------------------------------------

# (m, n, g holes): n below, equal to and above the tile sizes 16, 48, 4096
# and 16384; the first four are JAX's own test shapes
EXTRACT_CASES = [(32, 128, 5), (64, 256, 33), (16, 128, 0), (8, 128, 1000),
                 (40, 16, 30), (30, 48, 9), (6, 4096, 40), (3, 5000, 100),
                 (500, 1, 60), (200, 3, 20), (100, 17, 50), (1, 700, 300)]


def _jax_extract(c, mask, m, n, g):
    g_pad = max(8, -(-max(g, 1) // 8) * 8)
    return jax_extract(jnp.asarray(c), jnp.asarray(mask), int(mask.sum()),
                       g_pad, m, n, interpret=True)


@pytest.mark.parametrize("tile,per_thread", [(16, 16), (16, 4), (48, 16),
                                             (4096, 16), (16384, 64)])
@pytest.mark.parametrize("m,n,g", EXTRACT_CASES)
def test_tiled_extract_bitwise_plain_and_jax(tile, per_thread, m, n, g):
    c, mask, nnz = masked_dense(m, n, g, seed=m + n + g)
    tc, tm = torch.from_numpy(c), torch.from_numpy(mask)
    for cap in (nnz, nnz + 7, nnz + 4096, max(nnz - 9, 0), nnz // 2, 0):
        got = er.extract_roll_tiles(tc, tm, cap, tile, per_thread)
        want = er.extract_roll_plain(tc, tm, cap)
        for x, y in zip(got, want):
            assert_bitwise(x, y)
        if cap == nnz:
            for x, y in zip(got, _jax_extract(c, mask, m, n, g)):
                assert_bitwise(x, y)


@pytest.mark.parametrize("tile", [16, 48, 4096])
@pytest.mark.parametrize("fill", [False, True])
def test_tiled_extract_of_empty_and_full_masks(tile, fill):
    m, n = 37, 29
    c = np.random.default_rng(5).standard_normal((m, n)).astype(np.float32)
    mask = np.full((m, n), fill)
    tc, tm = torch.from_numpy(c), torch.from_numpy(mask)
    for cap in (0, 5, m * n, m * n + 3):
        got = er.extract_roll_tiles(tc, tm, cap, tile)
        for x, y in zip(got, er.extract_roll_plain(tc, tm, cap)):
            assert_bitwise(x, y)
    assert got[0][-1] == (m * n if fill else 0)


@pytest.mark.parametrize("lanes", [1, 5, 32])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lookback_gives_the_exclusive_scan(lanes, seed):
    """The look-back, under random interleavings of the tiles, windows of
    `lanes` status words and tiles with no kept cell, gives each tile the
    exclusive prefix of the counts."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4097, 300)
    counts[rng.choice(300, 40, replace=False)] = 0
    got = er.lookback_prefixes(counts, lanes, seed=seed)
    assert got == (np.cumsum(counts) - counts).tolist()
    assert er.lookback_prefixes([7], lanes, seed=seed) == [0]
