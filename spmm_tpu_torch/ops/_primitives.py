"""Tensor building blocks shared by the container and the kernels.

Ports `spmm_tpu/ops/_primitives.py`'s sorting, reduction and conversion
set: the pieces the alg1 SpGEMM, SpMV, SpMM, serving and ESC paths need.
Indices are int32 (`INDEX_DTYPE`), as in the JAX package; flat dense
offsets are formed in int64, since row*k+col passes 2^31 at large shapes.
Everything is deterministic on every device (stable sorts, the in-order
`segment_sum_inorder` of `kernels/segment_sum.py`, the fixed doubling tree
of `segsum_tree`), except `segment_sum_rows` on a CUDA tensor (a plain
version, never on a card path), which adds with atomics.  None of these
functions reads a value back to the host, apart from `to_host` and
`to_device`, which move whole int32 arrays in one copy each: sizes that
depend on the data are passed in by callers that have read them.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops.kernels.segment_sum import (  # noqa: F401
    segment_sum_inorder)

INDEX_DTYPE = torch.int32


def _can_fuse_key(shape: Tuple[int, int]) -> bool:
    return int(shape[0]) * int(shape[1]) < 2**31


_F32 = struct.Struct("f")


def f32(x) -> float:
    """A Python scalar rounded to float32 once, so every version (kernel,
    plain, JAX's `jnp.asarray(alpha, float32)`) multiplies by the same
    value.  Packing to 4 bytes rounds as numpy's cast does, without its
    per-call cost (the kernel wrappers call this on every call); what the
    packer refuses (a finite value past float32's range, which numpy makes
    inf) goes through numpy."""
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except (OverflowError, struct.error):
        return float(np.float32(x))


def scalar_as(x, dtype: torch.dtype):
    """A scalar (a Python number, a 0-d array or tensor) rounded to `dtype`
    once, as JAX's `jnp.asarray(alpha, a.dtype)` rounds it, as a Python
    number: float32 through `f32`; otherwise through a float64 or
    complex128 tensor cast to `dtype` (a complex value cast to a real dtype
    keeps its real part, with torch's warning)."""
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        x = x.item()
    if dtype == torch.float32 and not isinstance(x, complex):
        return f32(x)
    wide = torch.complex128 if isinstance(x, complex) else torch.float64
    return torch.tensor(x, dtype=wide).to(dtype).item()


def lexsort_rowcol(row: torch.Tensor, col: torch.Tensor,
                   carried: Sequence[torch.Tensor], shape):
    """Stable-sort COO triplets into (row, col) lexicographic order.

    Returns (row_sorted, col_sorted, tuple_of_carried_sorted).  A fused
    int32 key row*ncols + col when m*n < 2^31, else two stable passes (by
    col, then by row; the second keeps the col order within equal rows).
    A stable sort's permutation is unique, so both give the JAX package's
    order exactly.  Payloads ride along by gather."""
    if _can_fuse_key(shape):
        key = row * int(shape[1]) + col
        order = torch.sort(key, stable=True).indices
    else:
        order = torch.sort(col, stable=True).indices
        order = order[torch.sort(row[order], stable=True).indices]
    return row[order], col[order], tuple(c[order] for c in carried)


def build_indptr(rows_sorted: torch.Tensor, nrows: int) -> torch.Tensor:
    """CSR indptr from sorted row ids (the `coo2csr` direction).  A search
    of the row bounds, not `bincount`, which reads its input's maximum back
    to the host on a CUDA tensor."""
    bounds = torch.arange(nrows + 1, dtype=rows_sorted.dtype,
                          device=rows_sorted.device)
    return torch.searchsorted(rows_sorted, bounds, out_int32=True)


def rows_from_indptr(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Per-entry row ids of a CSR (the `csr2coo` direction)."""
    m = indptr.numel() - 1
    rows = torch.arange(m, dtype=INDEX_DTYPE, device=indptr.device)
    return torch.repeat_interleave(rows, (indptr[1:] - indptr[:-1]).long(),
                                   output_size=nnz)


def is_sorted_canonical(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """True iff (row, col) pairs are strictly increasing lexicographically:
    sorted and duplicate-free."""
    if row.numel() <= 1:
        return torch.ones((), dtype=torch.bool, device=row.device)
    row_ok = row[1:] > row[:-1]
    col_ok = (row[1:] == row[:-1]) & (col[1:] > col[:-1])
    return torch.all(row_ok | col_ok)


def new_group(row_sorted: torch.Tensor, col_sorted: torch.Tensor
              ) -> torch.Tensor:
    """True where a run of equal (row, col) pairs starts."""
    head = torch.ones(1, dtype=torch.bool, device=row_sorted.device)
    return torch.cat([head, (row_sorted[1:] != row_sorted[:-1])
                      | (col_sorted[1:] != col_sorted[:-1])])


def count_unique_sorted(row_sorted: torch.Tensor, col_sorted: torch.Tensor
                        ) -> torch.Tensor:
    """Number of distinct (row, col) pairs in lex-sorted coordinates, as a
    0-d int64 tensor on their device."""
    if row_sorted.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=row_sorted.device)
    return new_group(row_sorted, col_sorted).sum()


_SPARE = 1024  # dropped slots for the unflagged positions' stores


def compact_positions(flags: torch.Tensor, count: int) -> torch.Tensor:
    """Positions (int32) of the first `count` set flags, in order.  A
    running count of the flags scatters each set position to its rank;
    every other position stores into one of `_SPARE` slots past `count`
    (spread, so that the stores do not queue on one address), which are
    dropped.  No host sync (`torch.nonzero` reads its size back); slots
    past the number of set flags hold 0."""
    src = torch.arange(flags.numel(), dtype=INDEX_DTYPE, device=flags.device)
    rank = torch.cumsum(flags, 0) - 1
    rank = torch.where(flags & (rank < count), rank,
                       (src & (_SPARE - 1)).long() + count)
    out = torch.zeros(count + _SPARE, dtype=INDEX_DTYPE, device=flags.device)
    return out.scatter_(0, rank, src)[:count]


def _run_bounds(row_sorted, col_sorted, nout: int):
    """(first position, length) of each of the nout runs of equal pairs."""
    heads = new_group(row_sorted, col_sorted)
    first_pos = compact_positions(heads, nout)
    # run i ends where run i + 1 starts (nout is the number of runs)
    end = torch.full((1,), heads.numel(), dtype=first_pos.dtype,
                     device=first_pos.device)
    return heads, first_pos, torch.cat([first_pos[1:], end]) - first_pos


def sum_duplicates_sorted(row_sorted: torch.Tensor, col_sorted: torch.Tensor,
                          data_sorted: torch.Tensor, nout: int):
    """Collapse equal (row, col) runs by summation; `nout` must be
    `count_unique_sorted(...)` (read on the host by the caller).

    Each run is summed in sorted order from +0.0 (`segment_sum_inorder`),
    as the JAX package's `jax.ops.segment_sum` does: the bits are JAX's for
    runs of every length.  `data_sorted` is (L,) or (L, W)."""
    if row_sorted.numel() == 0:
        return row_sorted, col_sorted, data_sorted
    _, first_pos, lengths = _run_bounds(row_sorted, col_sorted, nout)
    return (row_sorted[first_pos], col_sorted[first_pos],
            segment_sum_inorder(data_sorted, first_pos, lengths))


def sum_duplicates_sorted_tree(row_sorted: torch.Tensor,
                               col_sorted: torch.Tensor,
                               data_sorted: torch.Tensor, nout: int):
    """`sum_duplicates_sorted` with each run summed by the fixed doubling
    tree of `segsum_tree`: ESC's compression, where the JAX package uses
    the tree too, so the bits are JAX's and `native/spgemm_cross_check.cpp`'s
    (the in-order sum and the tree differ in the last place for runs of
    three or more entries)."""
    if row_sorted.numel() == 0:
        return row_sorted, col_sorted, data_sorted
    heads, first_pos, lengths = _run_bounds(row_sorted, col_sorted, nout)
    scanned = segsum_tree(data_sorted, heads)
    return (row_sorted[first_pos], col_sorted[first_pos],
            scanned[first_pos + lengths - 1])


def has_canonical_format_sorted(row: torch.Tensor, col: torch.Tensor
                                ) -> torch.Tensor:
    """True iff lex-sorted coordinates contain no duplicate (row, col)."""
    if row.numel() <= 1:
        return torch.ones((), dtype=torch.bool, device=row.device)
    return ~torch.any((row[1:] == row[:-1]) & (col[1:] == col[:-1]))


def segsum_tree(values: torch.Tensor, head_flags: torch.Tensor
                ) -> torch.Tensor:
    """Segmented inclusive sum via Hillis-Steele doubling, fixed order.

    `head_flags[i]` is True where a segment starts; a segment's total is
    the value at its last position.  Each step is computed from the
    previous step's arrays (never in place), on the JAX package's exact
    schedule, x[i] <- x[i] + x[i - d] unless a head lies in (i - d, i],
    so the floating-point reduction tree, and with it every bit, is the
    one `native/spgemm_cross_check.cpp` replays."""
    n = values.numel()
    x, stop = values, head_flags
    d = 1
    while d < n:
        nx = torch.empty_like(x)
        torch.where(stop[d:], x[d:], x[d:] + x[:-d], out=nx[d:])
        # JAX shifts in zeros here; x + 0 only differs from x at -0.0
        torch.where(stop[:d], x[:d], x[:d] + 0.0, out=nx[:d])
        nstop = torch.empty_like(stop)
        torch.bitwise_or(stop[d:], stop[:-d], out=nstop[d:])
        nstop[:d] = True
        x, stop = nx, nstop
        d *= 2
    return x


def csr_transpose(indptr: torch.Tensor, indices: torch.Tensor,
                  data: torch.Tensor, shape: Tuple[int, int]):
    """(indptr, indices, data) of the CSR of Aᵀ, shape (n, m).

    A stable sort of the entries on column keeps them in row order within
    each new row, so a canonical A gives a canonical Aᵀ, and the result is
    deterministic on every device.  The new indptr comes from
    `searchsorted`, which needs no host sync."""
    m, n = shape
    order = torch.sort(indices, stable=True).indices
    cols_sorted = indices[order]
    rows = rows_from_indptr(indptr, data.numel())
    bounds = torch.arange(n + 1, dtype=cols_sorted.dtype,
                          device=indices.device)
    t_indptr = torch.searchsorted(cols_sorted, bounds, out_int32=True)
    return t_indptr, rows[order], data[order]


def segment_sum_rows(values: torch.Tensor, indptr: torch.Tensor
                     ) -> torch.Tensor:
    """Per-row sums of `values` (nnz,) or (nnz, k) over a CSR's rows: the
    plain version of the SpMV/SpMM reductions.  `index_add_` is
    deterministic on the CPU; on a CUDA tensor it adds with atomics, so
    reruns there may differ in the last bits (the kernels do not)."""
    m = indptr.numel() - 1
    rows = rows_from_indptr(indptr, values.shape[0])
    out = torch.zeros((m, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, rows, values)


def to_host(*tensors: torch.Tensor):
    """Host numpy copies of 1-D int32 tensors of one device, read back in one
    copy (one host sync on a card)."""
    sizes = [t.numel() for t in tensors]
    flat = torch.cat(tensors).cpu().numpy()
    return np.split(flat, np.cumsum(sizes)[:-1])


def to_device(device, *arrays):
    """1-D int32 tensors on `device` holding the host `arrays` (flattened),
    sent in one copy (one host sync on a card); views of one buffer."""
    flat = [np.asarray(x, np.int32).ravel() for x in arrays]
    buf = torch.from_numpy(np.concatenate(flat)).to(device)
    return torch.split(buf, [x.size for x in flat])


def plus_zero(x: torch.Tensor) -> torch.Tensor:
    """x + 0: the values JAX stores where it adds into zeros
    (`zeros.at[i].add(x)`), which differ from x only at -0.0 (+0.0)."""
    return x if x.dtype == torch.bool else x + 0


def csr_to_dense_canonical(indptr: torch.Tensor, indices: torch.Tensor,
                           data: torch.Tensor,
                           shape: Tuple[int, int]) -> torch.Tensor:
    """Dense (m, k) of a canonical CSR.  Positions are unique, so the
    assignment is a plain deterministic scatter; a stored zero stays 0."""
    m, k = shape
    rows = rows_from_indptr(indptr, data.numel())
    flat = rows.long() * k + indices.long()
    out = torch.zeros(m * k, dtype=data.dtype, device=data.device)
    out[flat] = data
    return out.view(m, k)
