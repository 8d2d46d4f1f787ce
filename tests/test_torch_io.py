"""The port's io (`spmm_tpu_torch.sparse.io`) against the JAX package's:
twins of the six tests of tests/test_io.py, on the CPU.

The matrix is made once with numpy and handed to both packages.  Text and
npz files saved by either package load bitwise in the other, and the two
packages' text files are byte-identical.  The SpMV plans are the port's
own format: built with `device="cpu"`, they round-trip bitwise through
the plain `spmv_routed` / `spmv_binned`, and a plan file that JAX's
`save_spmv_plan` wrote is refused, as is a forged version.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spmm_tpu.sparse import io as jio  # noqa: E402
from spmm_tpu_torch.ops.kernels import spmv_binned as kb  # noqa: E402
from spmm_tpu_torch.ops.kernels import spmv_routed as kr  # noqa: E402
from spmm_tpu_torch.sparse import io  # noqa: E402
from torch_port_helpers import (assert_bitwise,  # noqa: E402
                                assert_csr_bitwise, pair)

SUFFIXES = ("_indptr.txt", "_indices.txt", "_data.txt", "_shape.txt")


@pytest.fixture
def mats():
    """(JAX CSR, port CSR on the CPU) of one 24 x 30 matrix, density 0.2,
    with an explicit zero and an empty row."""
    return pair(24, 30, 0.2, seed=0, zeros=1, empty_rows=(5,))


def test_text_roundtrip(tmp_path, mats):
    ref, mat = mats
    prefix = str(tmp_path / "m")
    io.save_csr_txt(prefix, mat)
    for suffix in SUFFIXES:
        assert os.path.exists(prefix + suffix)
    back = io.load_csr_txt(prefix, device="cpu")
    assert back.device.type == "cpu" and back.has_canonical_format
    # %.9g round-trips float32 exactly
    assert_csr_bitwise(back, mat)
    # the JAX package writes the same bytes, and each loads the other's
    jprefix = str(tmp_path / "j")
    jio.save_csr_txt(jprefix, ref)
    for suffix in SUFFIXES:
        with open(prefix + suffix, "rb") as f, open(jprefix + suffix,
                                                    "rb") as g:
            assert f.read() == g.read(), suffix
    assert_csr_bitwise(io.load_csr_txt(jprefix, device="cpu"), ref)
    assert_csr_bitwise(jio.load_csr_txt(prefix), mat)


def test_csrs_txt_equal(tmp_path, mats):
    ref, mat = mats
    p1, p2, p3 = (str(tmp_path / x) for x in "abc")
    io.save_csr_txt(p1, mat)
    io.save_csr_txt(p2, mat)
    jio.save_csr_txt(p3, ref)
    assert io.csrs_txt_equal(p1, p2) and io.csrs_txt_equal(p1, p3)
    assert jio.csrs_txt_equal(p1, p3)
    io.save_csr_txt(p2, mat._with_data(mat.data * 2))
    assert not io.csrs_txt_equal(p1, p2)
    assert not jio.csrs_txt_equal(p1, p2)


def test_npz_roundtrip(tmp_path, mats):
    ref, mat = mats
    path, jpath = str(tmp_path / "m.npz"), str(tmp_path / "j.npz")
    io.save_npz(path, mat)
    jio.save_npz(jpath, ref)
    back = io.load_npz(path, device="cpu")
    assert back.device.type == "cpu" and back.has_canonical_format
    assert_csr_bitwise(back, mat)
    assert_csr_bitwise(io.load_npz(jpath, device="cpu"), ref)
    assert_csr_bitwise(jio.load_npz(path), mat)
    with np.load(path) as f, np.load(jpath) as g:
        assert sorted(f.files) == sorted(g.files)
        for key in f.files:
            assert f[key].dtype == g[key].dtype, key
            assert_bitwise(f[key], g[key])


def test_text_format_matches_reference_protocol(tmp_path, mats):
    """Ints as %d, floats as %.9g, one value per line: the format the
    native cross-check binary reads (gen_and_save_alg1_txt.py:8-15)."""
    _, mat = mats
    prefix = str(tmp_path / "m")
    io.save_csr_txt(prefix, mat)
    lines = open(prefix + "_indptr.txt").read().splitlines()
    assert len(lines) == mat.shape[0] + 1
    assert all(line.lstrip("-").isdigit() for line in lines)
    dlines = open(prefix + "_data.txt").read().splitlines()
    assert len(dlines) == mat.nnz
    assert dlines == ["%.9g" % v for v in mat.data.tolist()]
    assert open(prefix + "_shape.txt").read() == "24 30\n"


def _plans(a):
    m, n = a.shape
    args = (a.indptr, a.indices, a.data, m, n)
    return [("routed", kr.spmv_routed_plan(*args, device="cpu")),
            ("routed", kr.spmv_routed_plan(*args, cut=3, ch=2,
                                           device="cpu")),
            ("binned", kb.spmv_binned_plan(*args, device="cpu"))]


def _spmv(tag, x, p):
    return (kr.spmv_routed if tag == "routed" else kb.spmv_binned)(x, p)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_spmv_plan_roundtrip(tmp_path, which):
    """Routed and binned plans persist and serve bitwise the built plan's
    SpMV; a loaded plan has zeroed counters and fresh scratch, and the
    binned plan's arrays are views of one int32 buffer."""
    _, a = pair(200, 180, 0.05, seed=4)
    tag, plan = _plans(a)[which]
    p = str(tmp_path / "plan.npz")
    io.save_spmv_plan(p, (tag, plan))
    tag2, plan2 = io.load_spmv_plan(p, device="cpu")
    assert tag2 == tag and type(plan2) is type(plan)
    for name, v, w in zip(plan._fields, plan, plan2):
        if name == "partial":
            assert (v is None) == (w is None)
            assert v is None or (w.shape == v.shape and w.dtype == v.dtype)
        elif isinstance(v, torch.Tensor):
            assert w.device.type == "cpu" and w.dtype == v.dtype, name
            assert_bitwise(w, v)
        else:
            assert w == v, name
    assert not plan2.counters.any()
    if tag == "binned":
        base = plan2.rows.untyped_storage().data_ptr()
        for name in ("class_off", "piece_end", "piece_row", "counters"):
            assert getattr(plan2, name).untyped_storage().data_ptr() == base
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(180)
                         .astype(np.float32))
    want = _spmv(tag, x, plan)
    for _ in range(2):
        assert_bitwise(_spmv(tag, x, plan2), want)


def test_spmv_plan_roundtrip_long_rows(tmp_path):
    """A matrix with rows past the binned plan's class bound (pieces) and
    the routed plan's cut (chunks)."""
    _, a = pair(40, 13000, 0.2, seed=9)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(13000)
                         .astype(np.float32))
    for i, (tag, plan) in enumerate(_plans(a)):
        assert (plan.long_rows.numel() if tag == "routed"
                else plan.piece_row.numel()) > 1
        p = str(tmp_path / f"plan{i}.npz")
        io.save_spmv_plan(p, (tag, plan))
        _, plan2 = io.load_spmv_plan(p, device="cpu")
        assert_bitwise(_spmv(tag, x, plan2), _spmv(tag, x, plan))


def test_spmv_plan_version_rejected(tmp_path):
    """A JAX plan file (no marker, format version 3), a file without a
    version and a forged version are all refused."""
    from spmm_tpu.ops.kernels.spmv_routed import \
        spmv_routed_plan as jplan

    ref, a = pair(64, 64, 0.1, seed=1)
    p = str(tmp_path / "plan.npz")
    jio.save_spmv_plan(p, ("routed", jplan(np.asarray(ref.indptr),
                                           np.asarray(ref.indices),
                                           np.asarray(ref.data), 64, 64)))
    with pytest.raises(ValueError, match="another package's plan of format "
                                         "version 3"):
        io.load_spmv_plan(p, device="cpu")
    io.save_spmv_plan(p, _plans(a)[0])
    with np.load(p) as f:
        stale = {k: f[k] for k in f.files if k != "plan_format_version"}
    np.savez(p, **stale)
    with pytest.raises(ValueError, match="format version None"):
        io.load_spmv_plan(p, device="cpu")
    np.savez(p, plan_format_version=np.int64(999), **stale)
    with pytest.raises(ValueError, match="format version 999"):
        io.load_spmv_plan(p, device="cpu")
    # JAX's loader does not take the port's file either
    np.savez(p, plan_format_version=np.int64(io.PLAN_FORMAT_VERSION),
             **stale)
    assert io.load_spmv_plan(p, device="cpu")[0] == "routed"
    with pytest.raises((ValueError, KeyError)):
        jio.load_spmv_plan(p)


def test_save_spmv_plan_rejects_other_plans(tmp_path):
    _, a = pair(20, 20, 0.2, seed=2)
    plan = _plans(a)[0][1]
    with pytest.raises(ValueError, match="expected"):
        io.save_spmv_plan(str(tmp_path / "p.npz"), ("binned", plan))
    with pytest.raises(ValueError, match="expected"):
        io.save_spmv_plan(str(tmp_path / "p.npz"), ("onehot", plan))


def test_loaders_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    _, a = pair(10, 12, 0.3, seed=3)
    prefix = str(tmp_path / "m")
    io.save_csr_txt(prefix, a)
    io.save_npz(prefix + ".npz", a)
    io.save_spmv_plan(prefix + "_plan.npz", _plans(a)[2])
    for load in (lambda: io.load_csr_txt(prefix),
                 lambda: io.load_npz(prefix + ".npz"),
                 lambda: io.load_spmv_plan(prefix + "_plan.npz")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load()
