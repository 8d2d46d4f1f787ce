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
    """The same matrix as a `spmm_tpu.CSR` and as the port's CSR."""
    import spmm_tpu as st
    from spmm_tpu_torch import from_reference

    indptr, indices, data = csr_arrays(m, n, density, seed, **kw)
    ref = st.CSR.from_parts(indptr, indices, data, (m, n), canonical=True)
    return ref, from_reference(ref)


def as_bits(x):
    """Host integer view of a numpy, JAX or torch array, for bitwise
    comparison (float32 -> uint32, bfloat16 -> uint16)."""
    if hasattr(x, "detach"):
        import torch

        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.uint32)
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
