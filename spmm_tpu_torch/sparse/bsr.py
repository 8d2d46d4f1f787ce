"""BSR (block sparse row) matrix on an explicit torch device.

Port of `spmm_tpu/sparse/bsr.py`: `data` of shape (nblocks, R, C), int32
`indices` (block-column ids) and `indptr` over block rows; default block
(8, 128).  `nnz` counts stored elements, block padding included, as scipy
does.  `csr_to_bsr` keeps only the blocks that hold an entry; the matrix
is zero-padded up to whole blocks.  A BSR's (block row, block column) pairs
are unique, as `csr_to_bsr` makes them, so the scatters of values into
blocks and of blocks into the dense form are plain assignments.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import (INDEX_DTYPE, SparseMatrix, as_data,
                                        as_tensor, checked_device,
                                        resolve_device, torch_dtype)

DEFAULT_BLOCKSIZE = (8, 128)


class BSR(SparseMatrix):
    format = "bsr"

    def __init__(self, arg1, shape=None, dtype=None, blocksize=None, *,
                 device=None):
        """BSR from `(data, indices, indptr)` with data (nblocks, R, C), or
        from any sparse matrix re-tiled at `blocksize`, on `device`
        (default: the device of the tensors given, else the card)."""
        dtype = torch_dtype(dtype)
        if isinstance(arg1, tuple) and len(arg1) == 3:
            data, indices, indptr = arg1
            dev = resolve_device(device, data, indices, indptr)
            data = as_data(data, dtype, dev)
            indices = as_tensor(indices, INDEX_DTYPE, dev)
            indptr = as_tensor(indptr, INDEX_DTYPE, dev)
            if data.dim() != 3:
                raise ValueError("BSR data must be (nblocks, R, C)")
            if shape is None:
                nb = int(indices.max()) + 1 if indices.numel() else 0
                shape = ((indptr.numel() - 1) * data.shape[1],
                         nb * data.shape[2])
            b = BSR._wrap(indptr, indices, data, shape)
        elif hasattr(arg1, "tocsr"):
            a = arg1.tocsr()
            b = csr_to_bsr(a if device is None else a.to(device),
                           blocksize=blocksize)
        else:
            raise ValueError("unsupported BSR constructor argument")
        self._set(b.indptr, b.indices,
                  b.data if dtype is None else b.data.to(dtype), b.shape)

    def _set(self, indptr, indices, data, shape):
        if data.dim() != 3 or indptr.dim() != 1 or indices.dim() != 1:
            raise ValueError("BSR data must be (nblocks, R, C), indptr and "
                             "indices 1-D")
        if indptr.dtype != INDEX_DTYPE or indices.dtype != INDEX_DTYPE:
            raise ValueError("indptr and indices must be int32")
        if not (indptr.device == indices.device == data.device):
            raise ValueError("indptr, indices and data must share a device")
        if indices.numel() != data.shape[0]:
            raise ValueError(f"{data.shape[0]} blocks but {indices.numel()} "
                             "block column ids")
        self.indptr, self.indices, self.data = indptr, indices, data
        self._shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def _wrap(cls, indptr, indices, data, shape) -> "BSR":
        """BSR of tensors already on one device (no copy, no host sync)."""
        obj = cls.__new__(cls)
        obj._set(indptr, indices, data, shape)
        return obj

    @classmethod
    def from_parts(cls, indptr, indices, data, shape, *,
                   device=None) -> "BSR":
        dev = resolve_device(device, data)
        return cls._wrap(as_tensor(indptr, INDEX_DTYPE, dev),
                         as_tensor(indices, INDEX_DTYPE, dev),
                         as_tensor(data, None, dev), shape)

    def _with_data(self, data) -> "BSR":
        return BSR._wrap(self.indptr, self.indices, data, self._shape)

    def to(self, device) -> "BSR":
        device = checked_device(device)
        return BSR._wrap(self.indptr.to(device), self.indices.to(device),
                         self.data.to(device), self._shape)

    # -- properties ----------------------------------------------------------

    @property
    def blocksize(self) -> Tuple[int, int]:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        """Stored elements, block padding included (scipy's definition)."""
        R, C = self.blocksize
        return self.nblocks * R * C

    @property
    def block_density(self) -> float:
        R, C = self.blocksize
        mb = -(-self._shape[0] // R)
        nb = -(-self._shape[1] // C)
        return self.nblocks / float(mb * nb) if mb and nb else 0.0

    @property
    def block_rows(self) -> torch.Tensor:
        return prim.rows_from_indptr(self.indptr, self.nblocks)

    # -- conversions ---------------------------------------------------------

    def tobsr(self, blocksize=None) -> "BSR":
        if blocksize is None or tuple(blocksize) == self.blocksize:
            return self
        return csr_to_bsr(self.tocsr(), blocksize=blocksize)

    def toarray(self, order=None, out=None) -> torch.Tensor:
        """Dense (m, n) tensor; every stored value is added to 0, as JAX's
        block scatter `.at[].add` does (a stored -0.0 reads +0.0)."""
        self._check_order(order, out)
        m, n = self._shape
        R, C = self.blocksize
        mb, nb = -(-m // R), -(-n // C)
        dense = torch.zeros((mb, nb, R, C), dtype=self.dtype,
                            device=self.device)
        dense[self.block_rows.long(), self.indices.long()] = \
            prim.plus_zero(self.data)
        return dense.transpose(1, 2).reshape(mb * R, nb * C)[:m, :n]

    def tocoo(self):
        """The nonzero entries in (row, col) order, as JAX's
        `dense_to_coo(toarray())`, without the dense intermediate (one host
        read of their count)."""
        from spmm_tpu_torch.sparse.coo import COO

        m, n = self._shape
        R, C = self.blocksize
        nblocks = self.nblocks
        dev = self.device
        r_in = torch.arange(R, dtype=INDEX_DTYPE, device=dev)
        c_in = torch.arange(C, dtype=INDEX_DTYPE, device=dev)
        row = (self.block_rows.view(-1, 1, 1) * R
               + r_in.view(1, R, 1)).expand(nblocks, R, C).reshape(-1)
        col = (self.indices.view(-1, 1, 1) * C
               + c_in.view(1, 1, C)).expand(nblocks, R, C).reshape(-1)
        vals = self.data.reshape(-1)
        keep = (vals != 0) & (row < m) & (col < n)
        pos = prim.compact_positions(keep, int(keep.sum()))
        row_s, col_s, (vals_s,) = prim.lexsort_rowcol(
            row[pos], col[pos], (vals[pos],), self._shape)
        return COO._wrap(row_s, col_s, vals_s, self._shape, canonical=True)

    def tocsr(self):
        return self.tocoo().tocsr()

    def transpose(self) -> "BSR":
        R, C = self.blocksize
        return self.tocsr().transpose().tobsr(blocksize=(C, R))


def csr_to_bsr(a, blocksize: Optional[Tuple[int, int]] = None) -> BSR:
    """Re-tile a CSR into dense (R, C) blocks, stored in (block row, block
    column) order; only blocks holding an entry are stored.  The order comes
    from a stable lexsort on the block ids and the block count from one
    host read."""
    R, C = (int(x) for x in (blocksize or DEFAULT_BLOCKSIZE))
    a = a.sum_duplicates()
    m, n = a.shape
    mb, nb = -(-m // R), -(-n // C)
    dev = a.device
    if a.nnz == 0:
        return BSR._wrap(torch.zeros(mb + 1, dtype=INDEX_DTYPE, device=dev),
                         torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                         torch.zeros((0, R, C), dtype=a.dtype, device=dev),
                         (m, n))
    row, col = a.rows, a.indices
    brow_s, bcol_s, (r_in, c_in, d_s) = prim.lexsort_rowcol(
        row // R, col // C, (row % R, col % C, a.data), (mb, nb))
    new_block = prim.new_group(brow_s, bcol_s)
    nblocks = int(new_block.sum())  # host sync
    block_id = torch.cumsum(new_block, 0) - 1
    data = torch.zeros((nblocks, R, C), dtype=a.dtype, device=dev)
    # unique positions (a is canonical); JAX adds into zeros: d + 0
    data[block_id, r_in.long(), c_in.long()] = prim.plus_zero(d_s)
    first = prim.compact_positions(new_block, nblocks)
    indptr = prim.build_indptr(brow_s[first], mb)
    return BSR._wrap(indptr, bcol_s[first], data, (m, n))
