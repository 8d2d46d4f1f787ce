"""The port's profiler, break-even calibration and measured dispatch table
against the JAX package's (`spmm_tpu.utils.profiler`,
`spmm_tpu.utils.tuning`, `spmm_tpu.ops.dispatch`), on the CPU.

The break-even twins point both packages at tables in `tmp_path`, as
tests/test_ops.py:131-157 does for JAX: the repository's
`.break_even.json` was measured on a TPU, and the port never reads it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.ops import dispatch as jdispatch  # noqa: E402
from spmm_tpu.utils import profiler as jprofiler  # noqa: E402
from spmm_tpu.utils import tuning as jtuning  # noqa: E402
from spmm_tpu_torch.ops import dispatch  # noqa: E402
from spmm_tpu_torch.utils import profiler, tuning  # noqa: E402


def _result(mod):
    return mod.BenchResult(name="spgemm_alg1", time_ms=1.5,
                           times_ms=[1.0, 3.0, 2.0, 1.25],
                           peak_hbm_bytes=3 * 2**20,
                           delta_hbm_bytes=5 * 2**20, out_shape=(4, 5),
                           dtype="float32", extra={"n": 4})


def test_bench_result_matches_jax():
    got, want = _result(profiler), _result(jprofiler)
    assert got.median_ms == want.median_ms == 1.625
    assert got.min_ms == want.min_ms == 1.0
    assert got.row() == want.row()
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    empty = profiler.BenchResult(name="x", time_ms=2.0)
    assert empty.median_ms == empty.min_ms == 2.0
    assert "n/a" in empty.row()


def test_benchmark_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.ones(3, 4)
    r = profiler.benchmark(fn, (x,), n_repeat=5, n_warmup=2, name="double",
                           device="cpu")
    assert len(calls) == 7
    assert r.name == "double" and len(r.times_ms) == 5
    assert all(t >= 0 for t in r.times_ms)
    assert r.time_ms == r.median_ms
    assert r.out_shape == (3, 4) and r.dtype == "torch.float32"
    assert profiler.benchmark(fn, (x,), device="cpu").name == "fn"


def test_measurements_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is measurable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiler.benchmark(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiler.profile_op("x", lambda: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiler.device_busy_ms(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tuning.calibrate_break_even(sizes=(64,), save_path=None)


def test_profile_op_on_cpu():
    r = profiler.profile_op("ones", lambda: torch.ones(7, 2), device="cpu")
    assert r.name == "ones" and len(r.times_ms) == 1 and r.time_ms >= 0
    assert r.out_shape == (7, 2)
    assert r.peak_hbm_bytes is None and r.delta_hbm_bytes is None
    assert profiler.device_memory_stats("cpu") == {}


def test_repeat_op_times_every_run():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(2)

    r = profiler.repeat_op("z", fn, runs=4, warmup=3, device="cpu")
    assert len(calls) == 7 and len(r.times_ms) == 4
    assert r.time_ms == pytest.approx(np.median(r.times_ms))


def test_repeat_op_skips_out_of_memory(capsys):
    def oom():
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 80.00 GiB")

    assert profiler.repeat_op("big", oom, device="cpu") is None
    out = capsys.readouterr().out
    assert out.startswith("[SKIP] big: OutOfMemoryError")
    with pytest.raises(torch.OutOfMemoryError):
        profiler.repeat_op("big", oom, device="cpu", oom_ok=False)


def test_repeat_op_raises_other_errors():
    def bad():
        raise ValueError("not a memory error")

    with pytest.raises(ValueError, match="not a memory error"):
        profiler.repeat_op("bad", bad, device="cpu")

    def runtime():
        raise RuntimeError("a kernel failed")

    with pytest.raises(RuntimeError, match="a kernel failed"):
        profiler.repeat_op("bad", runtime, device="cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiler.trace(str(path)):
        torch.ones(16).sum()
    assert "traceEvents" in json.loads(path.read_text())


@pytest.mark.parametrize("nnz", [0, 1, 1000, 12_345_678])
def test_speed_of_light_and_rate(nnz):
    assert profiler.speed_of_light_spmv_s(nnz) == nnz * 8 / 3.35e12
    assert profiler.speed_of_light_spmv_s(nnz, hbm_gbps=819.0) == \
        jprofiler.speed_of_light_spmv_s(nnz)
    assert profiler.nnz_per_second(nnz, 2.0) == \
        jprofiler.nnz_per_second(nnz, 2.0)
    assert profiler.nnz_per_second(nnz, 0.0) == float("inf")


def test_utils_exports_match_jax():
    import spmm_tpu.utils as jutils

    names = [n for n in dir(jutils) if not n.startswith("_")
             and callable(getattr(jutils, n))]
    assert names and all(callable(getattr(pt.utils, n)) for n in names)


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Point both packages' tuning modules at `tmp_path / name`; drop the
    cached tables before and after."""
    def point(name):
        path = str(tmp_path / name)
        monkeypatch.setattr(jtuning, "_DEFAULT_CACHE", path)
        monkeypatch.setattr(tuning, "_DEFAULT_CACHE", path)
        jdispatch.reload_break_even()
        dispatch.reload_break_even()
        return path

    yield point
    jdispatch.reload_break_even()
    dispatch.reload_break_even()


@pytest.mark.parametrize("scale,want", [(512, 0.25), (1024, 0.25),
                                        (1025, 0.01), (4096, 0.01),
                                        (8192, 0.01), (50000, 0.01)])
def test_dispatch_honors_measured_break_even(tables, scale, want):
    """tests/test_ops.py:131: a saved table drives break_even_density, the
    entry at or above the scale, the largest beyond it."""
    path = tables("be.json")
    with open(path, "w") as f:
        json.dump({"1024": 0.25, "8192": 0.01}, f)
    assert dispatch.break_even_density(scale, 64, 64) == want
    assert jdispatch.break_even_density(scale, 64, 64) == want
    assert pt.break_even_density(64, scale, 64) == want


def test_measured_table_drives_matmul_auto(tables, monkeypatch):
    """At a table's crossover A @ X goes dense; below it, sparse."""
    from torch_port_helpers import pair

    path = tables("be.json")
    with open(path, "w") as f:
        json.dump({"64": 0.2}, f)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (64, 8), dtype=np.float32))
    calls = []
    real = dispatch.spmm

    def spy(a, b, **kw):
        calls.append(kw.get("via", "csr"))
        return real(a, b, **kw)

    monkeypatch.setattr(dispatch, "spmm", spy)
    for density in (0.3, 0.1):
        _, a = pair(64, 64, density, seed=1)
        pt.matmul(a, x)
    assert calls == ["dense", "csr"]


def test_reload_break_even_rereads_the_table(tables):
    path = tables("be.json")
    assert dispatch.break_even_density(4096, 8, 8) == 3e-2  # the curve
    with open(path, "w") as f:
        json.dump({"4096": 0.5}, f)
    assert dispatch.break_even_density(4096, 8, 8) == 3e-2  # cached
    dispatch.reload_break_even()
    assert dispatch.break_even_density(4096, 8, 8) == 0.5


def test_load_break_even_missing(tables, tmp_path):
    """tests/test_ops.py:153: no table gives None, and the curve."""
    tables("none.json")
    for mod in (tuning, jtuning):
        assert mod.load_break_even(str(tmp_path / "none.json")) is None
        assert mod.load_break_even() is None
    assert dispatch.break_even_density(4096, 8, 8) == \
        jdispatch.break_even_density(4096, 8, 8) == 3e-2


def test_default_table_is_the_ports_own():
    import os

    assert os.path.basename(tuning._DEFAULT_CACHE) == ".break_even_torch.json"
    assert os.path.realpath(tuning._DEFAULT_CACHE) != \
        os.path.realpath(jtuning._DEFAULT_CACHE)


def test_calibrate_break_even_on_cpu(tmp_path, capsys):
    path = tmp_path / "cal.json"
    table = tuning.calibrate_break_even(sizes=(64,), densities=(0.01, 0.5),
                                        device="cpu", save_path=str(path))
    assert set(table) == {64} and table[64] in (0.01, 0.5, 1.0)
    assert tuning.load_break_even(str(path)) == table
    out = capsys.readouterr().out
    assert "n=64 d=0.01: sparse" in out and "n=64 d=0.5: sparse" in out
    assert f"saved break-even table to {path}" in out
    assert tuning.calibrate_break_even(sizes=(32,), densities=(0.1,),
                                       device="cpu", save_path=None,
                                       verbose=False).keys() == {32}
