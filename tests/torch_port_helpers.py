"""Shared inputs and checks for the tests of the PyTorch port.

Every input is made with numpy from a seed, then handed as the same host
arrays to the JAX package (`spmm_tpu.CSR.from_parts`) and to the port
(`spmm_tpu_torch.from_reference`): torch cannot reproduce `jax.random`'s
bits, so neither package draws its own.
"""

import numpy as np


def csr_arrays(m, n, density, seed, zeros=0, empty_rows=()):
    """Canonical CSR (indptr, indices, data) as numpy arrays: distinct
    positions without replacement, U[0,1) float32 values.  `zeros` stored
    values are set to 0.0 (explicit zeros); rows in `empty_rows` are
    emptied."""
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(m * n, size=int(density * m * n),
                              replace=False))
    data = rng.random(flat.size, dtype=np.float32)
    keep = ~np.isin(flat // n, empty_rows)
    flat, data = flat[keep], data[keep]
    if zeros:
        data[rng.choice(data.size, size=zeros, replace=False)] = 0.0
    counts = np.bincount(flat // n, minlength=m)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return indptr, (flat % n).astype(np.int32), data


def f64_csr_arrays(m, n, seed):
    """Canonical float64 CSR (indptr, indices, data) as numpy arrays with
    empty rows (0, 1, 77, m - 1), short rows of up to 11 entries, two full
    rows (3, 150) and one of 120 (200); standard-normal values.  m >= 201,
    n >= 120."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, m)
    lens[[0, 1, 77, m - 1]] = 0
    lens[[3, 150]] = n
    lens[200] = 120
    indices = np.concatenate([np.sort(rng.choice(n, int(k), replace=False))
                              for k in lens]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return indptr, indices, rng.standard_normal(indices.size)


def unsorted_csr_arrays(m, n, density, seed, max_run=2):
    """CSR (indptr, indices, data) in no column order and with duplicates:
    int(density*m*n) distinct positions, each stored 1..max_run times,
    shuffled within its row; U[0,1) float32 values.  m*n may pass 2^31."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=int(density * m * n), replace=False)
    flat = np.repeat(flat.astype(np.int64),
                     rng.integers(1, max_run + 1, flat.size))
    rng.shuffle(flat)
    flat = flat[np.argsort(flat // n, kind="stable")]
    counts = np.bincount(flat // n, minlength=m)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    data = rng.random(flat.size, dtype=np.float32)
    return indptr, (flat % n).astype(np.int32), data


def coo_arrays(m, n, density, seed):
    """(row, col, data) of int(density*m*n) distinct positions in drawn
    (unsorted) order, as `spmm_tpu.random` returns them; U[0,1) float32."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=int(density * m * n), replace=False)
    data = rng.random(flat.size, dtype=np.float32)
    return ((flat // n).astype(np.int32), (flat % n).astype(np.int32),
            data)


def sparse_pair(m, n, density, seed, fmt="csr"):
    """The same `coo_arrays` matrix as a `spmm_tpu` container and as the
    port's on the CPU, each converted to `fmt` by its own package."""
    import spmm_tpu as st
    import spmm_tpu_torch as pt

    row, col, data = coo_arrays(m, n, density, seed)
    ref = st.COO((data, (row, col)), shape=(m, n)).asformat(fmt)
    got = pt.COO((data, (row, col)), shape=(m, n),
                 device="cpu").asformat(fmt)
    return ref, got


# the structure arrays of each format, compared bitwise by `assert_same`
STRUCTURE = {"coo": ("row", "col"), "csr": ("indptr", "indices"),
             "csc": ("indptr", "indices"), "bsr": ("indptr", "indices"),
             "dia": ()}


def assert_same(got, want, rtol=None):
    """A port container against a `spmm_tpu` one: format, shape, canonical
    flag and structure (offsets of a DIA) bitwise; data bitwise, or within
    rtol and atol = rtol * max|want| when `rtol` is given."""
    assert got.format == want.format, (got.format, want.format)
    assert tuple(got.shape) == tuple(want.shape)
    if got.format in ("coo", "csr", "csc"):
        assert got.has_canonical_format == want.has_canonical_format
    for name in STRUCTURE[got.format]:
        assert_bitwise(getattr(got, name), np.asarray(getattr(want, name)))
    if got.format == "dia":
        assert got._offsets == tuple(want._offsets)
    w = np.asarray(want.data)
    if rtol is None:
        assert_bitwise(got.data, w)
    else:
        atol = rtol * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(got.data.numpy(), w, rtol=rtol, atol=atol)


def masked_dense(m, n, g, seed):
    """(c, mask, kept count): a float32 (m, n) product with `g` holes, as
    in tests/test_extract_roll.py."""
    rng = np.random.default_rng(seed)
    mask = np.ones((m, n), bool)
    if g:
        holes = rng.choice(m * n, size=g, replace=False)
        mask.ravel()[holes] = False
    c = rng.standard_normal((m, n)).astype(np.float32) * mask
    return c, mask, int(mask.sum())


def pair(m, n, density, seed, **kw):
    """The same matrix as a `spmm_tpu.CSR` and as the port's CSR on the
    CPU."""
    import spmm_tpu as st
    from spmm_tpu_torch import from_reference

    indptr, indices, data = csr_arrays(m, n, density, seed, **kw)
    ref = st.CSR.from_parts(indptr, indices, data, (m, n), canonical=True)
    return ref, from_reference(ref, device="cpu")


def unsorted_pair(m, n, density, seed, **kw):
    """`unsorted_csr_arrays` as an unflagged `spmm_tpu.CSR` and as the
    port's CSR on the CPU."""
    import spmm_tpu as st
    import spmm_tpu_torch as pt

    arrays = unsorted_csr_arrays(m, n, density, seed, **kw)
    return (st.CSR.from_parts(*arrays, (m, n)),
            pt.CSR.from_parts(*arrays, (m, n), device="cpu"))


def assert_csr_bitwise(got, want):
    """Shape, indptr, indices and data bit for bit."""
    assert tuple(got.shape) == tuple(want.shape)
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert_bitwise(x, y)


def as_bits(x):
    """Host integer view of a numpy, JAX or torch array, for bitwise
    comparison (float32 -> uint32, bfloat16 -> uint16, float64 -> uint64,
    complex -> the bits of its (real, imaginary) pairs)."""
    if hasattr(x, "detach"):
        import torch

        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.resolve_conj().numpy()
    x = np.asarray(x)
    if x.dtype.kind == "c":
        x = np.stack([x.real, x.imag], -1)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    if x.dtype == np.float64:
        return x.view(np.uint64)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x


def assert_bitwise(got, want):
    got, want = as_bits(got), as_bits(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def assert_csr_match(got, want, rtol=1e-6):
    """Structure (indptr, indices) bitwise; values within rtol and
    atol = rtol * max|want| (the GEMMs sum in different orders)."""
    assert tuple(got.shape) == tuple(want.shape)
    assert_bitwise(got.indptr, np.asarray(want.indptr))
    assert_bitwise(got.indices, np.asarray(want.indices))
    w = np.asarray(want.data)
    g = got.data.cpu().numpy()
    atol = rtol * float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
