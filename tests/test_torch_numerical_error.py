"""The port's numerical-error study (`spmm_tpu_torch.experiments.
numerical_error`) on the CPU, at sizes of at most 64, held against the JAX
package on the same host arrays.

For each subcommand the port's operands go, as host arrays, to
`spmm_tpu.spgemm`: C1 and C3 have JAX's structure bitwise and values
within rtol 1e-6 plus atol 1e-6 * max|C| (alg1's GEMM and the blocked
alg3 engines sum in another order; ESC's C3 is bitwise JAX's).  Every
reported max |C1 - C3| is JAX's on those arrays to within what the values
themselves differ by (max |C1 - J1| + max |C3 - J3|) and 4 ulps of the
error; with ESC's C3 in both packages, where the error is not 0, the
reported error is JAX's bit for bit.  `range`'s values are
`jax.random.uniform(key, shape, float32, 0, high)` bit for bit, given the
same U[0, 1) draws.
"""

import importlib
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spmm_tpu_torch.experiments import numerical_error as ne  # noqa: E402
from torch_port_helpers import (assert_bitwise,  # noqa: E402
                                assert_csr_bitwise, assert_csr_match)

CPU = ["--device", "cpu", "--json"]
TOL = 1e-6
sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")


def _as_jax(x):
    import spmm_tpu as st

    return st.CSR.from_parts(x.indptr.numpy(), x.indices.numpy(),
                             x.data.numpy(), tuple(x.shape), canonical=True)


def _jax_pair(a, b, cf, impl="auto"):
    """JAX's C1 and C3 of the port's operands' host arrays."""
    import spmm_tpu as st

    ra, rb = _as_jax(a), _as_jax(b)
    return (st.spgemm(ra, rb, alg=1),
            st.spgemm(ra, rb, alg=3, chunk_fraction=cf, impl=impl))


def _jax_err(j1, j3) -> float:
    return float(np.abs(np.asarray(j1.toarray())
                        - np.asarray(j3.toarray())).max())


def _apart(c, j) -> float:
    """max |c - j| over the entries of one structure."""
    if not c.nnz:
        return 0.0
    return float(np.abs(c.data.double().numpy()
                        - np.asarray(j.data, np.float64)).max())


def _held(size, density, seed, cf, high=None, impl="auto"):
    """The port's C1, C3 against JAX's: (JAX's max |C1 - C3|, how far the
    port's may lie from it, by the values' own differences)."""
    a, b = ne.operands(size, density, seed, "cpu", high=high)
    c1, c3 = ne.alg1_alg3(a, b, cf)
    j1, j3 = _jax_pair(a, b, cf, impl)
    assert_csr_match(c1, j1)
    assert_csr_match(c3, j3)
    return _jax_err(j1, j3), _apart(c1, j1) + _apart(c3, j3)


def _rows(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def _close(got: float, want: float, apart: float):
    """The reported error is JAX's within `apart` and 4 ulps of it."""
    slack = apart + 4 * float(np.spacing(np.float32(want)))
    assert abs(got - want) <= slack, (got, want, apart)


def test_error_heatmap_vs_jax(capsys):
    ne.main(["error", "--sizes", "32", "64", "--densities", "0.1", "0.5"]
            + CPU)
    rows = _rows(capsys)
    assert [(r["size"], r["density"]) for r in rows] == [
        (32, 0.1), (32, 0.5), (64, 0.1), (64, 0.5)]
    for r in rows:
        _close(r["max_err"], *_held(r["size"], r["density"], 0, 0.3))
        assert r["max_err"] <= TOL * r["max_abs_c"]


def test_distribution_vs_jax(capsys):
    (row,) = ne.main(["distribution", "--size", "48", "--density", "0.2"]
                     + CPU)
    assert _rows(capsys) == [row]
    _close(row["max_err"], *_held(48, 0.2, 0, 0.3))
    assert 0 <= row["mean_err"] <= row["max_err"]


def test_fraction_alg1_vs_jax(capsys):
    fractions = [0.05, 0.3, 1.0]
    rows = ne.main(["fraction", "--size", "64", "--density", "0.1",
                    "--fractions", *map(str, fractions)] + CPU)
    assert [r["chunk_fraction"] for r in rows] == fractions
    a, b = ne.operands(64, 0.1, 0, "cpu")
    for r in rows:
        c1, c3 = ne.alg1_alg3(a, b, r["chunk_fraction"])
        j1, j3 = _jax_pair(a, b, r["chunk_fraction"])
        assert_csr_match(c1, j1)
        assert_csr_match(c3, j3)
        _close(r["max_err"], _jax_err(j1, j3),
               _apart(c1, j1) + _apart(c3, j3))


def test_fraction_f64_structure_and_error(capsys):
    """`--ref f64` passes its structure asserts; its error is JAX's C3
    against the same float64 product, to 1e-6 max|C|."""
    rows = ne.main(["fraction", "--size", "64", "--density", "0.2",
                    "--ref", "f64", "--fractions", "0.1", "0.5"] + CPU)
    a, b = ne.operands(64, 0.2, 0, "cpu")
    ref = ne.f64_reference(a, b)
    for r in rows:
        assert r["ref"] == "f64" and r["max_err"] <= TOL * r["max_abs_c"]
        c3 = ne.alg1_alg3(a, b, r["chunk_fraction"])[1]
        _, j3 = _jax_pair(a, b, r["chunk_fraction"])
        np.testing.assert_array_equal(np.asarray(j3.indptr), ref.indptr)
        np.testing.assert_array_equal(np.asarray(j3.indices), ref.indices)
        want = float(np.abs(np.asarray(j3.data, np.float64)
                            - ref.data).max())
        _close(r["max_err"], want, _apart(c3, j3))


def test_fraction_f64_refuses_another_structure(monkeypatch):
    """The structure assert raises where alg3 drops an entry."""
    def spgemm_dropping(a, b, alg=0, chunk_fraction=0.2, **kw):
        import spmm_tpu_torch as pt

        c = sg.spgemm(a, b, alg=alg, chunk_fraction=chunk_fraction, **kw)
        keep = torch.ones(c.nnz, dtype=torch.bool)
        keep[0] = False
        rows = torch.repeat_interleave(torch.arange(c.shape[0]),
                                       torch.diff(c.indptr.long()))
        return pt.COO.from_parts(rows[keep], c.indices[keep], c.data[keep],
                                 c.shape, device="cpu").tocsr()

    import spmm_tpu_torch as pt

    monkeypatch.setattr(pt, "spgemm", spgemm_dropping)
    with pytest.raises(AssertionError, match="another structure"):
        ne.main(["fraction", "--size", "32", "--density", "0.2", "--ref",
                 "f64", "--fractions", "0.5"] + CPU)


def test_range_vs_jax(capsys):
    highs = [1.0, 1000.0]
    rows = ne.main(["range", "--size", "32", "--density", "0.2", "--repeats",
                    "2", "--highs", *map(str, highs)] + CPU)
    assert [r["high"] for r in rows] == highs
    for r in rows:
        assert r["repeats"] == 2
        held = [_held(32, 0.2, rep * 2, 0.3, high=r["high"])
                for rep in range(2)]
        _close(r["max_err"], max(w for w, _ in held),
               max(d for _, d in held))


@pytest.mark.parametrize("high", [1.0, 7.0, 1000.0, 10000.0, 3.3e5])
@pytest.mark.parametrize("seed", [0, 11])
def test_scale_uniform_is_jax_uniform(high, seed):
    """jax.random.uniform(key, (k,), float32, 0, high) is the scaling of
    its own U[0, 1) draws from the same key, bit for bit."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, (4099,), jnp.float32))
    want = jax.random.uniform(key, (4099,), jnp.float32, 0.0, high)
    assert_bitwise(ne.scale_uniform(torch.from_numpy(u.copy()), high), want)


def test_range_operands_are_scaled_draws():
    a, _ = ne.operands(40, 0.2, 4, "cpu")
    h, _ = ne.operands(40, 0.2, 4, "cpu", high=100.0)
    assert_csr_bitwise(h, type(a)._wrap(a.indptr, a.indices,
                                        ne.scale_uniform(a.data, 100.0),
                                        a.shape, canonical=True))
    assert float(h.data.max()) < 100.0 and float(h.data.min()) >= 0.0


@pytest.mark.parametrize("cf", [0.1, 0.5])
def test_esc_c3_bitwise_jax(monkeypatch, cf):
    """With the blocked engines out of reach, C3 is ESC in both packages,
    and bitwise."""
    monkeypatch.setattr(sg, "_blocked_feasible", lambda a, b: False)
    a, b = ne.operands(64, 0.3, 5, "cpu")
    c1, c3 = ne.alg1_alg3(a, b, cf)
    j1, j3 = _jax_pair(a, b, cf, impl="esc")
    assert_csr_match(c1, j1)
    assert_csr_bitwise(c3, j3)


ESC_ARGV = {
    "error": ["error", "--sizes", "32", "64", "--densities", "0.2", "0.5"],
    "distribution": ["distribution", "--size", "48", "--density", "0.2"],
    "fraction": ["fraction", "--size", "64", "--density", "0.3",
                 "--fractions", "0.1", "0.5"],
    "range": ["range", "--size", "32", "--density", "0.2", "--repeats", "2",
              "--highs", "10000"],
}


@pytest.mark.parametrize("cmd", sorted(ESC_ARGV))
def test_reported_error_is_jax_on_esc(monkeypatch, capsys, cmd):
    """With ESC's C3 in both packages (the blocked engines out of reach in
    the port, `impl="esc"` in JAX) C1 and C3 differ, and each reported
    max |C1 - C3|, and the count of entries that differ, is JAX's bit for
    bit: a driver that misreports the error fails here."""
    monkeypatch.setattr(sg, "_blocked_feasible", lambda a, b: False)
    rows = ne.main(ESC_ARGV[cmd] + CPU)
    assert _rows(capsys) == rows and rows
    for r in rows:
        diffs = []
        for seed in ([0, 2] if cmd == "range" else [0]):
            a, b = ne.operands(r["size"], r["density"], seed, "cpu",
                               high=r.get("high"))
            j1, j3 = _jax_pair(a, b, r["chunk_fraction"], impl="esc")
            diffs.append(np.abs(np.asarray(j1.toarray())
                                - np.asarray(j3.toarray())))
        want = max(float(d.max()) for d in diffs)
        assert r["max_err"] > 0 and r["max_err"] == want, (r, want)
        if "nonzero" in r:
            assert r["nonzero"] == int(np.count_nonzero(diffs[0]))


def test_plot_without_matplotlib_raises(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ne.main(["error", "--sizes", "16", "--plot"] + CPU)
    assert capsys.readouterr().out == ""


def test_plot_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "heat.png"
    ne.main(["error", "--sizes", "16", "32", "--densities", "0.2", "--plot",
             "--out", str(out), "--device", "cpu"])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
