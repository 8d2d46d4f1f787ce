"""The operands' laws, and the four first cells pinned to their bits.

* `uniform` found by the law lookup (a matrix entry with no `law`, and one
  that names it) gives `uniform_csr`'s bits;
* `stencil27` is HPCG's `GenerateProblem_ref`, held against a plain loop
  of it at a grid that is not a cube, and its row lengths at HPCG's
  104^3 follow from a formula checked against built grids;
* every cell's inputs at its laws' small sizes repeat for one seed, and
  the cells that the parent commit of the law lookup had read as they did
  there: operands, the reference's answers, the timed call's answers and
  the work count, by a sha256 recorded at that commit.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

import hashlib
import itertools
import json
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import harness, operands  # noqa: E402
from cardbench.files import load_file  # noqa: E402

CELLS = [w["name"] for w in harness.read_json(ROOT / "BENCHMARK.json")
         ["workloads"]]
LAWS = ROOT / "cardbench" / "laws"
SEED = 2**31 + 77
# sha256 of `digest(cell)` at the commit before the law lookup (b671354)
PINS = {
    "n1024-d0.1.alg1":
        "aa163fcc893d96e09eff7dc52dce5a2f6a8b75ac15a967967a5963109de59c35",
    "n8192-d0.001.auto":
        "aa163fcc893d96e09eff7dc52dce5a2f6a8b75ac15a967967a5963109de59c35",
    "n1024-d0.1.alg3":
        "aa163fcc893d96e09eff7dc52dce5a2f6a8b75ac15a967967a5963109de59c35",
    "n1024-d0.1.plan":
        "9e35eb5e021819892ebf0f7692cfcb3912fc1d8034365eeb5f7097d17119d0ae",
}


def law(name):
    return load_file(LAWS / f"{name}.py")


def test_uniform_through_the_law_lookup_is_uniform_csr():
    uniform = law("uniform")
    spec = {"rows": 70, "cols": 90, "density": 0.07, "seed_offset": 3}
    for m in (spec, dict(spec, law="uniform")):
        got = operands.make({"dtype": "float32", "matrices": {"A": m}},
                            2**31 + 11, "cpu", ROOT)["A"]
        want = uniform.uniform_csr(70, 90, 0.07, 2**31 + 14, torch.float32,
                                   "cpu")
        assert got.shape == want.shape
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
        assert [x.dtype for x in got[:3]] == [torch.int32, torch.int32,
                                              torch.float32]


def hpcg_loop(nx, ny, nz):
    """`GenerateProblem_ref`'s loops on one process, as plain Python."""
    indptr, cols, vals = [0], [], []
    for iz, iy, ix in itertools.product(range(nz), range(ny), range(nx)):
        row = iz * nx * ny + iy * nx + ix
        for sz in (-1, 0, 1):
            if not 0 <= iz + sz < nz:
                continue
            for sy in (-1, 0, 1):
                if not 0 <= iy + sy < ny:
                    continue
                for sx in (-1, 0, 1):
                    if not 0 <= ix + sx < nx:
                        continue
                    col = row + sz * nx * ny + sy * nx + sx
                    cols.append(col)
                    vals.append(26.0 if col == row else -1.0)
        indptr.append(len(cols))
    return indptr, cols, vals


@pytest.mark.parametrize("grid", [[5, 4, 3], [3, 5, 4], [2, 1, 3]])
def test_stencil27_is_hpcg_generate_problem(grid):
    m = law("stencil27").make({"law": "stencil27", "grid": grid}, 123,
                              torch.float64, "cpu")
    indptr, cols, vals = hpcg_loop(*grid)
    n = grid[0] * grid[1] * grid[2]
    assert m.shape == (n, n)
    assert m.indptr.dtype == m.indices.dtype == torch.int32
    assert m.data.dtype == torch.float64
    assert m.indptr.tolist() == indptr
    assert m.indices.tolist() == cols
    assert m.data.tolist() == vals
    for r in range(n):
        row = cols[indptr[r]:indptr[r + 1]]
        assert row == sorted(set(row))


def row_lengths(grid):
    """{row length: rows} of the 27-point stencil, from the grid alone: along
    an axis of n >= 2 points, n - 2 have 3 neighbours in reach and 2 have 2;
    a row's length is the product over the axes."""
    axes = [{3: n - 2, 2: 2} if n >= 2 else {1: 1} for n in grid]
    counts = Counter()
    for combo in itertools.product(*(a.items() for a in axes)):
        length = combo[0][0] * combo[1][0] * combo[2][0]
        counts[length] += combo[0][1] * combo[1][1] * combo[2][1]
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("grid", [[5, 4, 3], [6, 5, 4], [2, 2, 2], [7, 1, 3]])
def test_stencil27_row_length_formula_against_built_grids(grid):
    m = law("stencil27").make({"grid": grid}, 0, torch.float32, "cpu")
    built = Counter((m.indptr[1:] - m.indptr[:-1]).tolist())
    assert row_lengths(grid) == dict(built)


def test_stencil27_at_hpcg_104_cubed():
    """HPCG's default local grid (`bin/hpcg.dat`: 104 104 104)."""
    counts = row_lengths([104, 104, 104])
    assert counts == {27: 1061208, 18: 62424, 12: 1224, 8: 8}
    assert sum(counts.values()) == 1124864
    assert sum(k * v for k, v in counts.items()) == 29791000


def test_stencil27_draws_nothing_from_the_seed_and_small_is_no_cube():
    make, small = law("stencil27").make, law("stencil27").small
    spec = {"law": "stencil27", "grid": [104, 104, 104]}
    assert small(spec) == {"law": "stencil27", "grid": [6, 5, 4]}
    a = make(small(spec), 1, torch.float64, "cpu")
    b = make(small(spec), 2**33 + 5, torch.float64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def feed(h, name, t):
    t = t.contiguous()
    h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
    h.update(t.numpy().tobytes())


def digest(cell):
    """sha256 of a cell at its laws' small sizes for SEED: its operands, the
    reference's answers and the timed call's answers of calls 0 to 2, and
    the work count."""
    c = harness.load_cell(cell, ROOT)
    config = dict(c.config, **harness.small(cell, ROOT))
    mats = operands.make(config, SEED, "cpu", ROOT)
    timed = harness.load_entry(c, ROOT).Timed(
        mats, c.traffic, config, config.get("precision"), SEED, "cpu")
    h = hashlib.sha256()
    for k in sorted(mats):
        for j, t in enumerate(mats[k][:3]):
            feed(h, f"{k}{j}", t)

    def parts(answer):
        return [answer] if isinstance(answer, torch.Tensor) else answer
    for i in range(3):
        for j, t in enumerate(parts(timed.expected(timed.key(i)))):
            feed(h, f"ref{i}.{j}", t)
        for j, t in enumerate(parts(timed.answer(timed.call(i)))):
            feed(h, f"out{i}.{j}", t)
    work = timed.work(timed.expected(timed.key(0)))
    h.update(json.dumps(work, sort_keys=True).encode())
    return h.hexdigest()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_inputs_are_pinned(cell):
    first = digest(cell)
    assert digest(cell) == first
    if cell in PINS:
        assert first == PINS[cell]


def test_the_pinned_cells_are_still_there():
    assert set(PINS) <= set(CELLS)
