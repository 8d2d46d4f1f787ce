"""The routed serving SpMV in float64 (HPCG's dtype) on the CPU.

`spmv_routed_plan` keeps a float64 CSR's values, slices and scratch in
float64, and `spmv(A, x, plan=("routed", p))` then runs the plan's plain
version in float64.  It is held against the benchmark's plain reference
(`cardbench/reference/spmv.py`, float64 sums of float64 products, loaded by
path with HPCG's matrix law `cardbench/laws/stencil27.py`) by the number
that decides a float64 cell's `correct`: value_err = max|y - r| / max|r|
within 1e-13.  Why 1e-13: sound float64 runs read at most 1.01e-15 on the
card at HPCG's 104^3, so the limit leaves 100x of room; the same check
with the operands rounded to float32 reads about 1e-8 and fails it.

The plan of a float64 matrix on the card is the one departure from the
JAX package's `spmv_plan` (None for every non-float32 matrix): off the
card it stays None, and host arrays still give a float32 plan.  Float32
plans keep their bits: digests of plans and answers are pinned at the
commit before float64 plans existed.
"""

import hashlib
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import spmm_tpu_torch as pt  # noqa: E402
from cardbench.files import load_file  # noqa: E402
from spmm_tpu_torch.models import power_law_rows  # noqa: E402
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels.spmv_binned import \
    spmv_binned_plan  # noqa: E402
from spmm_tpu_torch.ops.kernels.spmv_routed import (  # noqa: E402
    spmm_routed, spmv_routed, spmv_routed_plan)
from spmm_tpu_torch.sparse import io  # noqa: E402
from spmm_tpu_torch.sparse.csr import CSR  # noqa: E402
from torch_port_helpers import (assert_bitwise, csr_arrays,  # noqa: E402
                                f64_csr_arrays)

# the module (the package's `ops.spmv` is the function)
spmv_mod = importlib.import_module("spmm_tpu_torch.ops.spmv")
REFERENCE = load_file(ROOT / "cardbench" / "reference" / "spmv.py")
STENCIL = load_file(ROOT / "cardbench" / "laws" / "stencil27.py")
# a float64 cell's limit on value_err (module docstring)
LIMIT = 1e-13


def value_err(y: torch.Tensor, r: torch.Tensor) -> float:
    """max|y - r| / max|r| in float64, as the benchmark's check."""
    assert y.shape == r.shape
    return float((y.double() - r).abs().max() / r.abs().max())


def stencil():
    """HPCG's matrix at the law's small grid, 6 x 5 x 4."""
    return STENCIL.make(STENCIL.small({"grid": [104, 104, 104]}), 0,
                        torch.float64, "cpu")


def random_f64(m=300, n=250, seed=5):
    """A canonical float64 CSR with empty rows, short rows and long rows
    (`f64_csr_arrays`)."""
    return STENCIL.Csr(*(torch.from_numpy(t) for t in
                         f64_csr_arrays(m, n, seed)), (m, n))


MATRICES = {"stencil": stencil, "random": random_f64}
# (cut, ch): every row in slices at the plan's defaults; rows past 8
# entries as chunks of 16 (the stencil's rows of 12, 18 and 27 too)
CUTS = {"default": {}, "chunks": {"cut": 8, "ch": 16}}


def port_csr(a):
    return CSR.from_parts(a.indptr, a.indices, a.data, a.shape,
                          canonical=True, device="cpu")


def x_of(a, seed=7, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(a.shape[1], generator=g, dtype=dtype)


def routed(a, dtype=torch.float64, **kw):
    return ("routed", spmv_routed_plan(a.indptr, a.indices,
                                       a.data.to(dtype), *a.shape,
                                       device="cpu", **kw))


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("which", sorted(MATRICES))
def test_routed_f64_within_the_cell_limit(which, cut):
    a = MATRICES[which]()
    plan = routed(a, **CUTS[cut])
    p = plan[1]
    assert p.data.dtype == p.sell_val.dtype == p.partial.dtype \
        == torch.float64
    if cut == "chunks":
        assert p.long_rows.numel() and p.chunk_row.numel() > \
            p.long_rows.numel()
    else:
        assert not p.long_rows.numel()
    A, x = port_csr(a), x_of(a)
    y = pt.spmv(A, x, plan=plan)
    assert y.dtype == torch.float64 and y.shape == (a.shape[0],)
    assert value_err(y, REFERENCE.spmv(a, x)) <= LIMIT
    assert_bitwise(y, pt.spmv(A, x, plan=plan))


@pytest.mark.parametrize("which", sorted(MATRICES))
def test_float32_operands_fail_the_limit(which):
    """The same check on operands rounded to float32 (a float32 plan and
    x): far past the limit, so the check tells the precisions apart."""
    a = MATRICES[which]()
    x = x_of(a)
    y = pt.spmv(port_csr(a).astype(torch.float32), x.float(),
                plan=routed(a, torch.float32))
    assert y.dtype == torch.float32
    assert 1e4 * LIMIT < value_err(y, REFERENCE.spmv(a, x)) < 1e-5


def test_spmv_plan_is_routed_in_float64_on_a_card(monkeypatch):
    """With the matrix taken for one on a card (the plan's own code then
    runs on the CPU), `spmv_plan` gives the float64 routed plan for "auto"
    and "max", and None for "fast" (the binned kernel is float32 only)."""
    a = port_csr(stencil())
    monkeypatch.setattr(spmv_mod, "_on_card", lambda a: True)
    for effort in ("auto", "max"):
        tag, p = pt.spmv_plan(a, effort=effort)
        assert tag == "routed" and p.sell_val.dtype == torch.float64
    assert pt.spmv_plan(a, effort="fast") is None
    x = x_of(stencil())
    y = pt.spmv(a, x, plan=pt.spmv_plan(a))
    assert value_err(y, REFERENCE.spmv(stencil(), x)) <= LIMIT


def test_spmv_plan_of_float64_is_none_off_the_card():
    a = port_csr(stencil())
    for effort in ("auto", "max", "fast"):
        assert pt.spmv_plan(a, effort=effort) is None


def test_host_float64_arrays_give_a_float32_plan():
    a = random_f64()
    host = spmv_routed_plan(*(t.numpy() for t in a[:3]), *a.shape,
                            device="cpu", cut=8, ch=16)
    assert host.data.dtype == host.sell_val.dtype == host.partial.dtype \
        == torch.float32
    tens = spmv_routed_plan(a.indptr, a.indices, a.data.float(), *a.shape,
                            cut=8, ch=16)
    x = x_of(a, dtype=torch.float32)
    assert_bitwise(spmv_routed(x, host), spmv_routed(x, tens))


def test_plan_and_x_dtypes_must_agree():
    a = random_f64()
    p = routed(a)[1]
    with pytest.raises(ValueError, match="contiguous 1-D float64"):
        spmv_routed(x_of(a, dtype=torch.float32), p)
    with pytest.raises(ValueError, match="float32 plans only"):
        spmm_routed(torch.ones((a.shape[1], 3)), p)
    for dtype in (torch.float16, torch.bfloat16, torch.complex64):
        with pytest.raises(ValueError, match="data must be"):
            spmv_routed_plan(a.indptr, a.indices, a.data.to(dtype), *a.shape,
                             device="cpu")
    # the binned plan stays float32 alone
    with pytest.raises(ValueError, match="data must be"):
        spmv_binned_plan(a.indptr, a.indices, a.data, *a.shape, device="cpu")


def test_spmm_ignores_a_float64_routed_plan():
    a = random_f64()
    A = port_csr(a)
    B = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (a.shape[1], 5)))
    plan = routed(a, cut=8, ch=16)
    got = pt.spmm(A, B, plan=plan)
    assert got.dtype == torch.float64
    assert_bitwise(got, pt.spmm(A, B))


def test_float64_plan_file_round_trips(tmp_path):
    """A float64 routed plan with long rows: saved, loaded with its scratch
    in float64, and the same y."""
    a = random_f64()
    plan = routed(a, cut=8, ch=16)
    path = tmp_path / "plan.npz"
    io.save_spmv_plan(str(path), plan)
    tag, q = io.load_spmv_plan(str(path), device="cpu")
    assert tag == "routed" and q.partial.dtype == torch.float64
    assert q.partial.numel() == plan[1].partial.numel() > 0
    x = x_of(a)
    assert_bitwise(spmv_routed(x, q), spmv_routed(x, plan[1]))
    before = dict(_build.LAUNCHES)
    pt.spmv(port_csr(a), x, plan=(tag, q))
    assert _build.LAUNCHES == before  # the CPU runs the plain version


def f32_plans():
    """Float32 routed plans of the inputs the port's SpMV tests use: two
    random CSRs (one with empty rows) and a power-law matrix, at the
    default cut and at cut 8, chunks of 16."""
    mats = {"300x256": csr_arrays(300, 256, 0.05, 0),
            "empty_rows": csr_arrays(90, 70, 0.1, 6,
                                     empty_rows=(0, 1, 44, 89))}
    pl = power_law_rows(512, 300, 8, seed=3, device="cpu")
    mats["powerlaw"] = (pl.indptr, pl.indices, pl.data)
    shapes = {"300x256": (300, 256), "empty_rows": (90, 70),
              "powerlaw": tuple(pl.shape)}
    for name, arrays in mats.items():
        t = tuple(torch.as_tensor(np.asarray(v)) for v in arrays)
        for kw in ({}, {"cut": 8, "ch": 16}):
            yield name, kw, spmv_routed_plan(*t, *shapes[name], **kw)


def f32_digest() -> str:
    """sha256 of every float32 plan of `f32_plans` (each tensor but its
    scratch `partial`, and the slice classes) and of its y and Y for fixed
    x and X."""
    h = hashlib.sha256()
    for name, kw, p in f32_plans():
        h.update(f"{name}|{sorted(kw.items())}|{p.classes}".encode())
        for field, v in p._asdict().items():
            if isinstance(v, torch.Tensor) and field != "partial":
                h.update(f"{field}|{v.dtype}|".encode())
                h.update(v.contiguous().numpy().tobytes())
        g = torch.Generator().manual_seed(p.n)
        x = torch.randn(p.n, generator=g)
        X = torch.randn((p.n, 6), generator=g)
        h.update(spmv_routed(x, p).numpy().tobytes())
        h.update(spmm_routed(X, p).numpy().tobytes())
    return h.hexdigest()


# `f32_digest()` at the commit before float64 plans (09b2aaf)
F32_PIN = ("3f5c3aa41149009a3d47de8c451e3458"
           "aa424b2160dc84b20f880aeccbe0abb2")


def test_float32_plans_keep_their_bits():
    assert f32_digest() == F32_PIN
