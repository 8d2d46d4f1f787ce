"""The port's ESC alg2/alg3 engine and its primitives against the JAX
package.

Every input is made with numpy (`torch_port_helpers`) and handed to both
packages.  ESC values are compared BITWISE: each partial product is one
f32 multiply, the lexsort is stable (its permutation is unique), and each
duplicate run is summed by the same fixed doubling tree
(`_primitives.segsum_tree`).  `sum_duplicates` sums each run in stored
order from +0.0, as JAX's `segment_sum` does on the CPU
(`_primitives.segment_sum_inorder`): bitwise too, for runs of every length.
"""

import importlib
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.sparse import io as jax_io  # noqa: E402
from spmm_tpu_torch.ops import _primitives as prim  # noqa: E402
from spmm_tpu_torch.ops.kernels import esc_compress  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, assert_csr_bitwise, assert_csr_match, pair,
    unsorted_csr_arrays, unsorted_pair)

jax_prim = importlib.import_module("spmm_tpu.ops._primitives")
jax_sg = importlib.import_module("spmm_tpu.ops.spgemm")
pt_sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")

REPO = pathlib.Path(__file__).resolve().parents[1]

# (m, k, n, density of A, density of B, seed, extra arguments of A)
ESC_CASES = {
    "square": (64, 64, 64, 0.1, 0.1, 0, {}),
    "nonsquare": (40, 72, 56, 0.2, 0.15, 1, {}),
    "tall_thin": (200, 30, 90, 0.1, 0.3, 2, {}),
    "explicit_zeros": (48, 48, 48, 0.15, 0.15, 3, {"zeros": 5}),
    "empty_rows": (50, 40, 30, 0.2, 0.2, 4, {"empty_rows": (0, 9, 49)}),
    "dense_output": (32, 32, 32, 0.9, 0.9, 5, {}),
    "headline_shape": (256, 256, 256, 0.1, 0.1, 6, {}),
}


def _operands(m, k, n, da, db, seed, kw):
    a_ref, a = pair(m, k, da, seed, **kw)
    b_ref, b = pair(k, n, db, seed + 100)
    return a_ref, a, b_ref, b


@pytest.mark.parametrize("name", list(ESC_CASES))
def test_esc_alg2_bitwise_vs_jax(name):
    a_ref, a, b_ref, b = _operands(*ESC_CASES[name])
    want = st.spgemm(a_ref, b_ref, alg=2, impl="esc")
    got = pt.spgemm(a, b, alg=2, impl="esc")
    assert got.has_canonical_format and got.nnz == want.nnz
    assert_csr_bitwise(got, want)


@pytest.mark.parametrize("cf", [1.0, 0.2, 0.05])
@pytest.mark.parametrize("name", ["square", "nonsquare", "explicit_zeros",
                                  "empty_rows", "headline_shape"])
def test_esc_alg3_bitwise_vs_jax(name, cf):
    a_ref, a, b_ref, b = _operands(*ESC_CASES[name])
    want = st.spgemm(a_ref, b_ref, alg=3, chunk_fraction=cf, impl="esc")
    got = pt.spgemm(a, b, alg=3, chunk_fraction=cf, impl="esc")
    assert got.has_canonical_format
    assert_csr_bitwise(got, want)


def test_alg3_esc_bitwise_invariant_across_chunk_fractions():
    """Twin of the JAX test of the same name: every chunk fraction, and
    alg2 itself, gives the same bits (the tree is position-relative
    within each run)."""
    a_ref, a, b_ref, b = _operands(80, 60, 70, 0.15, 0.15, 7, {})
    ref = pt.spgemm(a, b, alg=2, impl="esc")
    for cf in (0.05, 0.2, 0.5, 1.0):
        assert_csr_bitwise(pt.spgemm(a, b, alg=3, chunk_fraction=cf,
                                     impl="esc"), ref)


@pytest.mark.parametrize("alpha", [2.5, -0.3, 0.0])
@pytest.mark.parametrize("alg", [2, 3])
def test_esc_alpha_bitwise_vs_jax(alg, alpha):
    a_ref, a, b_ref, b = _operands(*ESC_CASES["nonsquare"])
    want = st.spgemm(a_ref, b_ref, alpha=alpha, alg=alg, impl="esc")
    got = pt.spgemm(a, b, alpha=alpha, alg=alg, impl="esc")
    assert_csr_bitwise(got, want)


@pytest.mark.parametrize("alg", [2, 3])
@pytest.mark.parametrize("which", ["a", "b", "disjoint"])
def test_esc_empty_products(alg, which):
    if which == "disjoint":
        # A stores column 0 only, B row 5 only: no product at all
        a_arr = (np.arange(9, dtype=np.int32), np.zeros(8, np.int32),
                 np.ones(8, np.float32))
        b_arr = (np.array([0] * 6 + [1] * 4, np.int32),
                 np.array([2], np.int32), np.ones(1, np.float32))
        a_ref = st.CSR.from_parts(*a_arr, (8, 9), canonical=True)
        b_ref = st.CSR.from_parts(*b_arr, (9, 7), canonical=True)
        a = pt.from_reference(a_ref, device="cpu")
        b = pt.from_reference(b_ref, device="cpu")
    else:
        a_ref, a = pair(20, 30, 0.0 if which == "a" else 0.2, 8)
        b_ref, b = pair(30, 25, 0.0 if which == "b" else 0.2, 9)
    want = st.spgemm(a_ref, b_ref, alg=alg, impl="esc")
    got = pt.spgemm(a, b, alg=alg, impl="esc")
    assert got.nnz == 0
    assert_csr_bitwise(got, want)


def test_esc_scipy_parity():
    """Twin of test_alg2_esc_joined_scipy_parity, for both ESC algs and
    both expansions."""
    a_ref, a, b_ref, b = _operands(100, 80, 120, 0.2, 0.2, 11, {})
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    ref.sort_indices()
    outs = [pt_sg._spgemm_alg2_esc(a, b, 1.0, joined=True),
            pt.spgemm(a, b, alg=2, impl="esc"),
            pt.spgemm(a, b, alg=3, chunk_fraction=0.3, impl="esc")]
    for c in outs:
        assert_bitwise(c.indptr, ref.indptr.astype(np.int32))
        assert_bitwise(c.indices, ref.indices.astype(np.int32))
        np.testing.assert_allclose(c.data.numpy(), ref.data, rtol=1e-6)
    assert_csr_bitwise(outs[0], outs[1])


@pytest.fixture(scope="module")
def native_replay(tmp_path_factory):
    """The C++ replay of the ESC expansion and doubling tree
    (`native/spgemm_cross_check.cpp`, the binary of experiments/
    cross_check), built with g++ into a temporary directory."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build native/spgemm_cross_check.cpp")
    exe = tmp_path_factory.mktemp("native") / "spgemm_cross_check"
    subprocess.run([gxx, "-O2", "-std=c++17", "-o", str(exe),
                    str(REPO / "native" / "spgemm_cross_check.cpp")],
                   check=True, capture_output=True, timeout=300)
    return exe


@pytest.mark.parametrize("size,density,alpha", [(64, 0.1, 1.0),
                                                (128, 0.5, 1.0),
                                                (96, 0.2, 0.75)])
def test_esc_bitwise_vs_native_replay(native_replay, tmp_path, size,
                                      density, alpha):
    """The port's ESC against the C++ replay directly, through the text
    protocol of experiments/cross_check (`%.9g` round-trips float32).
    The binary reads an argument that starts with "-" as a flag, so alpha
    stays positive."""
    a_ref, a = pair(size, size, density, size)
    b_ref, b = pair(size, size, density, size + 1)
    pa, pb, pc = (str(tmp_path / x) for x in "ABC")
    jax_io.save_csr_txt(pa, a_ref)
    jax_io.save_csr_txt(pb, b_ref)
    subprocess.run([str(native_replay), pa, pb, pc, repr(alpha)],
                   check=True, capture_output=True, timeout=300)
    want = jax_io.load_csr_txt(pc)
    for alg, cf in ((2, 0.2), (3, 0.2), (3, 0.05)):
        got = pt.spgemm(a, b, alpha=alpha, alg=alg, chunk_fraction=cf,
                        impl="esc")
        assert_csr_bitwise(got, want)


@pytest.mark.parametrize("seed,shape,dens", [(0, (64, 48, 80), 0.15),
                                             (1, (128, 128, 128), 0.05),
                                             (2, (33, 97, 51), 0.3)])
def test_expand_joined_bitwise_matches_gather_expand(seed, shape, dens):
    """`_expand_joined` returns JAX's b-position order bitwise, and the
    sorted triplets of both expansions are identical."""
    m, k, n = shape
    a_ref, a, b_ref, b = _operands(m, k, n, dens, dens, seed, {})
    counts, ends = pt_sg._work_estimation(a.indices, b.indptr)
    P = int(ends[-1])
    jc, je = jax_sg._work_estimation(a_ref.indices, b_ref.indptr)
    assert P == int(je[-1])
    args = (a.rows, a.indices, a.data, b.indptr, b.indices, b.data, counts,
            ends, P)
    jargs = (a_ref.rows, a_ref.indices, a_ref.data, b_ref.indptr,
             b_ref.indices, b_ref.data, jc, je, P)
    for got, want in zip(pt_sg._expand_joined(*args, k),
                         jax_sg._expand_joined(*jargs, k)):
        assert_bitwise(got, np.asarray(want))
    for got, want in zip(pt_sg._expand(*args), jax_sg._expand(*jargs)):
        assert_bitwise(got, np.asarray(want))
    out_j = pt_sg._esc_expand_sort_count(*args, m, n, k, True)
    out_g = pt_sg._esc_expand_sort_count(*args, m, n, k, False)
    want = jax_sg._esc_expand_sort_count(*jargs, m, n, k, False)
    for x, y, w in zip(out_j, out_g, want):
        assert_bitwise(x, y)
        assert_bitwise(x.to(torch.int32) if x.dim() == 0 else x,
                       np.asarray(w))


def test_spgemm_keywords_accepted():
    """`chunk_fraction`, `verbose` and `impl` as in `spmm_tpu.spgemm`; the
    verbose lines are the JAX package's."""
    a_ref, a, b_ref, b = _operands(*ESC_CASES["square"])
    c = pt.spgemm(a, b, 1.0, 3, 0.2, False, "highest", "esc")
    assert_csr_bitwise(c, st.spgemm(a_ref, b_ref, alg=3, chunk_fraction=0.2,
                                    impl="esc"))
    c = pt.spgemm(a, b, alg=3, chunk_fraction=0.2, verbose=False, impl="esc")
    assert c.nnz > 0


def test_spgemm_verbose_matches_jax(capsys):
    a_ref, a, b_ref, b = _operands(*ESC_CASES["square"])
    for alg, impl in ((1, "auto"), (3, "esc")):
        st.spgemm(a_ref, b_ref, alg=alg, chunk_fraction=0.2, verbose=True,
                  impl=impl)
        want = capsys.readouterr().out
        pt.spgemm(a, b, alg=alg, chunk_fraction=0.2, verbose=True, impl=impl)
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("cf", [0.0, 5.0])
def test_chunk_fraction_clamps_as_jax(cf):
    a_ref, a, b_ref, b = _operands(*ESC_CASES["nonsquare"])
    assert_csr_bitwise(
        pt.spgemm(a, b, alg=3, chunk_fraction=cf, impl="esc"),
        st.spgemm(a_ref, b_ref, alg=3, chunk_fraction=cf, impl="esc"))


@pytest.mark.parametrize("alg", [2, 3])
@pytest.mark.parametrize("impl", ["dense", "auto"])
def test_blocked_engine_raises(alg, impl):
    """"dense", and "auto" where the panels fit, run the blocked engine as
    in JAX (the name is kept from when it was not ported and raised): the
    structure is JAX's bitwise, the values within the GEMM tolerance.  An
    unknown impl still raises."""
    a_ref, a, b_ref, b = _operands(*ESC_CASES["square"])
    assert_csr_match(pt.spgemm(a, b, alg=alg, impl=impl),
                     st.spgemm(a_ref, b_ref, alg=alg, impl=impl))
    with pytest.raises(ValueError, match="unknown impl"):
        pt.spgemm(a, b, alg=alg, impl="hash")
    # impl only selects the alg2/alg3 engine: alg 1 runs either way
    assert pt.spgemm(a, b, alg=1, impl=impl).nnz > 0


def test_auto_runs_esc_where_blocked_does_not_fit():
    """m*n past 2^31: alg 0 is past the dense budget and the blocked engine
    does not apply, so "auto" runs ESC, as in JAX; the lexsort takes its
    two-pass form."""
    a_ref, a = pair(60000, 20, 2e-3, 21)
    b_ref, b = pair(20, 60000, 2e-3, 22)
    assert not pt_sg._blocked_feasible(a, b)
    want = st.spgemm(a_ref, b_ref, alg=0)
    for alg in (0, 2, 3):
        assert_csr_bitwise(pt.spgemm(a, b, alg=alg), want)


def test_product_count_past_int32_raises():
    pt_sg._check_products(2**31 - 1, "alg=2")
    with pytest.raises(ValueError, match="2\\^31"):
        pt_sg._check_products(2**31, "alg=2")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(50, 40), (70000, 70000)])
def test_lexsort_rowcol_bitwise_vs_jax(shape):
    """Fused int32 key below 2^31 cells, two stable passes past it."""
    m, n = shape
    rng = np.random.default_rng(3)
    row = rng.integers(0, m, 3000).astype(np.int32)
    col = rng.integers(0, n, 3000).astype(np.int32)
    row[:500], col[:500] = row[500:1000], col[500:1000]  # duplicate pairs
    val = rng.standard_normal(3000).astype(np.float32)
    assert prim._can_fuse_key(shape) == (m * n < 2**31)
    got = prim.lexsort_rowcol(torch.from_numpy(row), torch.from_numpy(col),
                              (torch.from_numpy(val),), shape)
    want = jax_prim.lexsort_rowcol(row, col, (val,), shape)
    assert_bitwise(got[0], np.asarray(want[0]))
    assert_bitwise(got[1], np.asarray(want[1]))
    assert_bitwise(got[2][0], np.asarray(want[2][0]))
    r, c = got[0], got[1]
    n_unique = int(prim.count_unique_sorted(r, c))
    assert n_unique == int(jax_prim.count_unique_sorted(np.asarray(r),
                                                        np.asarray(c)))
    assert not bool(prim.has_canonical_format_sorted(r, c))
    assert bool(prim.has_canonical_format_sorted(r[:1], c[:1]))


def test_segsum_tree_bitwise_vs_jax():
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 1000, 4099):
        vals = rng.standard_normal(n).astype(np.float32)
        vals[::17] = -0.0
        heads = rng.random(n) < 0.1
        heads[0] = True
        got = prim.segsum_tree(torch.from_numpy(vals),
                               torch.from_numpy(heads))
        assert_bitwise(got, np.asarray(jax_prim.segsum_tree(vals, heads)))
    # a first position that is not a head, as JAX computes it
    heads[0] = False
    got = prim.segsum_tree(torch.from_numpy(vals), torch.from_numpy(heads))
    assert_bitwise(got, np.asarray(jax_prim.segsum_tree(vals, heads)))


def test_compact_positions_vs_jax():
    rng = np.random.default_rng(5)
    flags = rng.random(5000) < 0.3
    count = int(flags.sum())
    got = prim.compact_positions(torch.from_numpy(flags), count)
    assert_bitwise(got, np.asarray(jax_prim.compact_positions(flags, count)))
    assert_bitwise(prim.compact_positions(torch.from_numpy(flags), 10),
                   np.asarray(jax_prim.compact_positions(flags, 10)))
    assert prim.compact_positions(torch.zeros(4, dtype=torch.bool),
                                  0).numel() == 0


@pytest.mark.parametrize("max_run", [2, 5])
def test_sum_duplicates_sorted_vs_jax(max_run):
    indptr, indices, data = unsorted_csr_arrays(60, 50, 0.2, 6,
                                                max_run=max_run)
    rows = np.repeat(np.arange(60), np.diff(indptr)).astype(np.int32)
    r, c, (d,) = jax_prim.lexsort_rowcol(rows, indices, (data,), (60, 50))
    nout = int(jax_prim.count_unique_sorted(r, c))
    want = jax_prim.sum_duplicates_sorted(r, c, d, nout)
    r_t, c_t, d_t = (torch.from_numpy(np.array(x)) for x in (r, c, d))
    assert int(prim.count_unique_sorted(r_t, c_t)) == nout
    got = prim.sum_duplicates_sorted(r_t, c_t, d_t, nout)
    for x, y in zip(got, want):
        assert_bitwise(x, np.asarray(y))
    # ESC's helper keeps the doubling tree, bit for bit JAX's segsum_tree
    tree = prim.sum_duplicates_sorted_tree(r_t, c_t, d_t, nout)
    heads = np.r_[True, (np.diff(np.asarray(r)) != 0)
                  | (np.diff(np.asarray(c)) != 0)]
    scanned = np.asarray(jax_prim.segsum_tree(np.asarray(d), heads))
    ends = np.r_[np.flatnonzero(heads)[1:], heads.size] - 1
    assert_bitwise(tree[2], scanned[ends])


@pytest.mark.parametrize("vals,want_bits", [
    # in order: (1 + 2^-24) rounds to 1, then 1 again; the tree adds the two
    # small terms first and gives 1 + 2^-23 (0x3f800001)
    ([1.0, 2.0**-24, 2.0**-24], [0x3F800000]),
    # a run of -0.0 sums from +0.0 in JAX: +0.0
    ([-0.0, -0.0, -0.0], [0x00000000]),
])
def test_sum_duplicates_in_order_rounding(vals, want_bits):
    d = np.array(vals, np.float32)
    r = np.zeros(d.size, np.int32)
    want = jax_prim.sum_duplicates_sorted(r, r, d, 1)[2]
    assert np.asarray(want).view(np.uint32).tolist() == want_bits
    r_t, d_t = torch.from_numpy(r), torch.from_numpy(d)
    got = prim.sum_duplicates_sorted(
        r_t, r_t, d_t, int(prim.count_unique_sorted(r_t, r_t)))
    assert_bitwise(got[2], np.asarray(want))
    # the (L, W) form sums each column the same way
    wide = prim.segment_sum_inorder(torch.stack([d_t, d_t], 1),
                                    torch.zeros(1, dtype=torch.long),
                                    torch.tensor([d.size]))
    assert_bitwise(wide, np.repeat(np.asarray(want), 2).reshape(1, 2))


# ---------------------------------------------------------------------------
# CSR.sum_duplicates and sort_indices on unsorted and duplicate input
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,density,max_run", [
    ((60, 50), 0.2, 2),
    ((60, 50), 0.2, 4),
    ((1, 300), 0.5, 3),
    ((70000, 70000), 6e-8, 2),   # m*n past 2^31: the two-pass lexsort
])
def test_sum_duplicates_vs_jax_and_scipy(shape, density, max_run):
    a_ref, a = unsorted_pair(*shape, density, 7, max_run=max_run)
    assert not a.check_canonical()
    want = a_ref.sum_duplicates()
    got = a.sum_duplicates()
    assert got.has_canonical_format and got.check_canonical()
    assert_csr_bitwise(got, want)
    ref = a.to_scipy().tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert_bitwise(got.indptr, ref.indptr.astype(np.int32))
    assert_bitwise(got.indices, ref.indices.astype(np.int32))
    np.testing.assert_allclose(got.data.numpy(), ref.data, rtol=1e-6)


def test_sum_duplicates_of_unflagged_canonical_input():
    a_ref, a = pair(30, 20, 0.2, 12)
    plain = pt.CSR.from_parts(a.indptr, a.indices, a.data, a.shape)
    assert_csr_bitwise(plain.sum_duplicates(), a)
    assert plain.sum_duplicates().has_canonical_format
    empty = pt.CSR.from_parts(np.zeros(4, np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.float32), (3, 5), device="cpu")
    assert empty.sum_duplicates().nnz == 0


def test_sort_indices_vs_jax():
    a_ref, a = unsorted_pair(40, 30, 0.2, 8, max_run=2)
    want = a_ref.sort_indices()
    for got in (a.sort_indices(), a.sorted_indices()):
        assert not got.has_canonical_format  # duplicates stay
        assert_csr_bitwise(got, want)


@pytest.mark.parametrize("alg", [1, 2, 3])
def test_spgemm_of_unsorted_duplicate_operands(alg):
    a_ref, a = unsorted_pair(40, 30, 0.15, 9, max_run=2)
    b_ref, b = unsorted_pair(30, 35, 0.15, 10, max_run=2)
    impl = "auto" if alg == 1 else "esc"
    got = pt.spgemm(a, b, alg=alg, impl=impl)
    want = st.spgemm(a_ref, b_ref, alg=alg, impl=impl)
    if alg == 1:
        assert_bitwise(got.indptr, np.asarray(want.indptr))
        assert_bitwise(got.indices, np.asarray(want.indices))
        w = np.asarray(want.data)
        np.testing.assert_allclose(got.data.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
    else:
        assert_csr_bitwise(got, want)


# ---------------------------------------------------------------------------
# the association of csrc/esc_compress.cu, replayed, and its plain version
# ---------------------------------------------------------------------------


def _tree(v):
    """A perfect binary tree over len(v) = 2^b values, each node right half
    + left half, by a stack of pending sums (the kernel's `tree_deep`)."""
    stack = []
    for i, x in enumerate(v):
        while i & 1:
            x = x + stack.pop()
            i >>= 1
        stack.append(x)
    return stack[0]


def _bits(x):
    """The bits of a numpy scalar or a 0-d torch tensor."""
    return x.tobytes() if isinstance(x, np.generic) else int(
        x.view(torch.int16))


def _run_total(v):
    """The doubling tree's total of one run: v[1:] cut left to right into
    blocks of the set bits of len(v) - 1, smallest first, each a perfect
    tree; total = B_1 + (B_2 + (... + (B_k + v[0])))."""
    acc, pos, rest = v[0], 1, len(v) - 1
    while rest:
        w = rest & -rest
        acc = _tree(v[pos:pos + w]) + acc
        pos, rest = pos + w, rest - w
    return acc


def _warp_run_total(v):
    """The same total as a warp of the kernel forms it: a block of 32 or
    more values cut into 32 subtrees, one a lane, joined pairwise (lane l
    and l ^ o, the higher lane's sum + the lower's)."""
    acc, pos, rest = v[0], 1, len(v) - 1
    while rest:
        w = rest & -rest
        if w < 32:
            block = _tree(v[pos:pos + w])
        else:
            sub = w // 32
            lanes = [_tree(v[pos + i * sub:pos + (i + 1) * sub])
                     for i in range(32)]
            o = 1
            while o < 32:
                lanes = [lanes[i] + lanes[i ^ o] if i & o
                         else lanes[i ^ o] + lanes[i] for i in range(32)]
                o *= 2
            assert len({_bits(x) for x in lanes}) == 1
            block = lanes[0]
        acc = block + acc
        pos, rest = pos + w, rest - w
    return acc


RUN_LENGTHS = {
    "1-70": list(range(1, 71)),
    "1023-1025": [1023, 1024, 1025],
    "4097": [4097],
    "neg_zero": [1, 2, 3, 40],
    "lone": [1025],
}


@pytest.mark.parametrize("lengths", list(RUN_LENGTHS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bfloat16"])
@pytest.mark.parametrize("replay", [_run_total, _warp_run_total],
                         ids=["thread", "warp"])
def test_tree_association_replay_bitwise_vs_segsum_tree(replay, dtype,
                                                        lengths):
    """Each run's total under `segsum_tree` (at the run's last position)
    is its replay in the association the kernel uses, bitwise: runs of the
    given lengths back to back (a lone run alone), values spread over
    seven decades so that the order of the additions shows.  bfloat16
    replays on 0-d tensors (each sum in float, rounded to bfloat16)."""
    lens = RUN_LENGTHS[lengths]
    bf16 = dtype == "bfloat16"
    rng = np.random.default_rng(len(lens) + (2 if bf16 else
                                             np.dtype(dtype).itemsize))
    total = sum(lens)
    if lengths == "neg_zero":
        vals = np.full(total, -0.0)
    else:
        vals = (rng.standard_normal(total)
                * 10.0 ** rng.integers(-3, 4, total))
    vals = (torch.from_numpy(vals).to(torch.bfloat16) if bf16
            else torch.from_numpy(vals.astype(dtype)))
    heads = np.zeros(total, bool)
    starts = np.cumsum([0] + lens[:-1])
    heads[starts] = True
    scanned = prim.segsum_tree(vals, torch.from_numpy(heads))
    vals = vals if bf16 else vals.numpy()
    got = [replay(list(vals[s:s + n])) for s, n in zip(starts, lens)]
    got = torch.stack(got) if bf16 else np.array(got, dtype)
    assert_bitwise(got, scanned[torch.from_numpy(starts + np.array(lens)
                                                 - 1)])
    if lengths == "neg_zero":
        assert torch.signbit(torch.as_tensor(got)).all()


def test_warp_split_replay_of_a_long_run():
    """A run of 70 001 (blocks of 65 536, 4096, 256, 64, 32 and 16): the
    warp's split and the thread's pass give the tree's bits."""
    vals = np.random.default_rng(9).standard_normal(70001).astype(np.float32)
    heads = np.zeros(vals.size, bool)
    heads[0] = True
    want = prim.segsum_tree(torch.from_numpy(vals),
                            torch.from_numpy(heads)).numpy()[-1:]
    assert_bitwise(np.array([_warp_run_total(list(vals))]), want)
    assert_bitwise(np.array([_run_total(list(vals))]), want)


def _sorted_triplets(m, n, P, max_run, seed, dtype=np.float32):
    """Lex-sorted (row, col, val) with runs of 1 to max_run equal pairs,
    about a tenth of the products -0.0."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, m * n, P))
    reps = rng.integers(1, max_run + 1, keys.size)
    keys = np.repeat(keys, reps)
    vals = rng.standard_normal(keys.size).astype(dtype)
    vals[rng.random(keys.size) < 0.1] = -0.0
    return ((keys // n).astype(np.int32), (keys % n).astype(np.int32),
            vals)


@pytest.mark.parametrize("alpha", [1.0, 1.5, -0.3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,max_run", [(40, 30, 1), (60, 50, 7),
                                         (1, 200, 40), (300, 7, 3)])
def test_compress_runs_plain_bitwise_vs_jax(m, n, max_run, dtype, alpha):
    """The wrapper on the CPU (its plain version) against JAX's ESC
    `_compress` and `count_unique_sorted`: indptr, columns and alpha times
    each run's tree sum, bitwise; and the same bits written as two chunks
    of rows into slices of one output (alg3's form)."""
    r, c, v = _sorted_triplets(m, n, 300, max_run, m + n + max_run, dtype)
    with jax.enable_x64(dtype == np.float64):
        nnz = int(jax_prim.count_unique_sorted(r, c))
        want = jax_sg._compress(r, c, v, jnp.asarray(alpha, v.dtype), nnz, m)
        want = [np.asarray(x) for x in want]
    rt, ct, vt = (torch.from_numpy(x) for x in (r, c, v))
    assert int(esc_compress.count_runs(rt, ct)) == nnz
    got = (torch.empty(m + 1, dtype=torch.int32),
           torch.empty(nnz, dtype=torch.int32), torch.empty(nnz, dtype=vt.dtype))
    esc_compress.compress_runs(rt, ct, vt, alpha, *got)
    for x, w in zip(got, want):
        assert_bitwise(x, w)
    # rows [0, cut) and [cut, m) apart, each at its offset
    cut = m // 2
    split = int(np.searchsorted(r, cut))
    off = int(want[0][cut])
    parts = (torch.empty(m + 1, dtype=torch.int32),
             torch.empty(nnz, dtype=torch.int32),
             torch.empty(nnz, dtype=vt.dtype))
    for lo, hi, p0, p1, base in ((0, cut, 0, split, 0),
                                 (cut, m, split, r.size, off)):
        end = nnz if hi == m else off
        esc_compress.compress_runs(
            rt[p0:p1], ct[p0:p1], vt[p0:p1], alpha, parts[0][lo:hi + 1],
            parts[1][base:end], parts[2][base:end], lo, base)
    for x, w in zip(parts, want):
        assert_bitwise(x, w)
