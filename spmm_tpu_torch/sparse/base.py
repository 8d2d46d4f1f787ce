"""Base class of the sparse containers, and the helpers they share.

Port of `spmm_tpu/sparse/base.py`: shape / dtype / device / nnz /
density, the conversion protocol (`tocoo`, `tocsr`, `tocsc`, `tobsr`,
`todia`, `asformat`, `toarray`), scalar arithmetic, the zero-preserving
ufuncs on stored values, reductions, extrema and comparisons, `reshape` /
`resize`, the scipy bridge, and `@` routed to `spmm_tpu_torch.ops.dispatch`.

Unlike the JAX containers, these hold tensors on one explicit device and
are not pytrees.  Where the JAX package computes on the host with numpy
(axis extrema, argmax/argmin, maximum/minimum and the comparisons against
the dense form, reshape, resize, getnnz), so does the port.  Axis sums,
which JAX adds with `.at[].add`, use the in-order
`_primitives.segment_sum_inorder` over sorted keys: JAX's bits, no atomics.
"""

from __future__ import annotations

import numbers
import warnings
from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim

INDEX_DTYPE = prim.INDEX_DTYPE


def checked_device(device) -> torch.device:
    """`device` as a torch.device; raises for CUDA where there is none
    (no quiet fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"cannot place a sparse matrix on {device}: CUDA "
                           "is not available")
    return device


def resolve_device(device, *given) -> torch.device:
    """`device` if set, else the device of the first tensor or sparse matrix
    among `given`, else the card."""
    if device is None:
        device = next((x.device for x in given
                       if isinstance(x, torch.Tensor) or issparse(x)), "cuda")
    return checked_device(device)


def torch_dtype(dtype):
    """A torch dtype from a torch or numpy dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def as_tensor(x, dtype, device) -> torch.Tensor:
    """Contiguous tensor on `device`; `dtype` None keeps x's type."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def as_data(x, dtype, device) -> torch.Tensor:
    """A constructor's values as a tensor on `device`.  With `dtype` None a
    tensor keeps its type and a host array converts as `jnp.asarray` does
    with x64 off (float64 to float32, int64 to int32, complex128 to
    complex64), as the JAX package's constructors do."""
    if dtype is None and not isinstance(x, torch.Tensor):
        kind = np.asarray(x).dtype.kind
        dtype = {"f": torch.float32, "i": torch.int32, "u": torch.int32,
                 "c": torch.complex64, "b": torch.bool}.get(kind)
    return as_tensor(x, dtype, device)


def host(x) -> np.ndarray:
    """A host numpy copy of a tensor (bfloat16, which numpy lacks, as its
    exact float32 values, as JAX's `to_scipy` gives them), or `np.asarray`
    of anything else."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_dense_2d(x) -> bool:
    return not issparse(x) and getattr(x, "ndim", None) == 2


def _is_scalar(x) -> bool:
    return isinstance(x, numbers.Number) or (
        isinstance(x, (torch.Tensor, np.ndarray, np.generic))
        and x.ndim == 0)


def _scalar(x):
    """A scalar operand as a Python number (a 0-d tensor is read back)."""
    return x.item() if isinstance(x, (torch.Tensor, np.ndarray,
                                      np.generic)) else x


def axis_sum(keys: torch.Tensor, data: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) sums of `data` grouped by `keys` in [0, n): a stable sort on the
    key keeps the stored order within a key, then each key's values are
    added in that order from 0, as JAX's `zeros.at[keys].add(data)` adds
    them on the CPU.  O(entries) after the sort, no host read."""
    order = torch.sort(keys, stable=True).indices
    keys_s = keys[order]
    bounds = torch.arange(n + 1, dtype=keys_s.dtype, device=keys.device)
    ptr = torch.searchsorted(keys_s, bounds)
    return prim.segment_sum_inorder(data[order], ptr[:-1], ptr[1:] - ptr[:-1])


class SparseMatrix:
    """Abstract base of COO, CSR, CSC, BSR and DIA."""

    format: str = "base"
    # numpy defers `ndarray @ sparse` to __rmatmul__ instead of trying to
    # wrap the matrix in an object array
    __array_ufunc__ = None

    # -- basic properties ----------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def getnnz(self, axis=None):
        """Stored-entry count, total or per column (axis 0) / row (axis 1),
        on the host as scipy's `getnnz`."""
        if axis is None:
            return self.nnz
        if axis in (0, -2):
            return np.bincount(host(self.tocoo().col), minlength=self.shape[1])
        if axis in (1, -1):
            return np.bincount(host(self.tocoo().row), minlength=self.shape[0])
        raise ValueError(f"axis out of range: {axis}")

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m and n else 0.0

    @property
    def T(self):
        return self.transpose()

    # -- conversion protocol -------------------------------------------------

    def tocoo(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def tocsr(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def tocsc(self):
        return self.tocsr().tocsc()

    def tobsr(self, blocksize=None):
        from spmm_tpu_torch.sparse import bsr

        return bsr.csr_to_bsr(self.tocsr(), blocksize=blocksize)

    def todia(self):
        from spmm_tpu_torch.sparse import dia

        return dia.coo_to_dia(self.tocoo())

    def todense(self, order=None, out=None):
        return self.toarray(order=order, out=out)

    def toarray(self, order=None, out=None):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def _check_order(order, out):
        """scipy's `toarray(order=, out=)` arguments.  'F' is accepted and
        gives the same values, row-major, as in the JAX package."""
        if order not in (None, "C", "F", "c", "f"):
            raise TypeError(f"order not understood: {order!r}")
        if out is not None:
            raise ValueError("sparse toarray does not support out=")

    def asformat(self, format: str):
        if format is None or format == self.format:
            return self
        convert = getattr(self, "to" + format, None)
        if convert is None:
            raise ValueError(f"Format {format!r} is unknown.")
        return convert()

    def transpose(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def to(self, device):  # pragma: no cover - abstract
        raise NotImplementedError

    def _with_data(self, data):  # pragma: no cover - abstract
        raise NotImplementedError

    def conj(self):
        return self._with_data(self.data.conj().resolve_conj())

    def copy(self):
        return self._with_data(self.data.clone())

    def astype(self, dtype):
        return self._with_data(self.data.to(torch_dtype(dtype)))

    def asfptype(self):
        """Float data as it is; other data as float32 (scipy's
        `asfptype`)."""
        if self.dtype.is_floating_point or self.dtype.is_complex:
            return self
        return self.astype(torch.float32)

    def __len__(self):
        raise TypeError("sparse matrix length is ambiguous; "
                        "use getnnz() or shape[0]")

    def __iter__(self):
        """Row iteration, as scipy's: each row a (1, n) CSR; other formats
        iterate over their CSR."""
        mat = self if self.format == "csr" else self.tocsr()
        for i in range(self.shape[0]):
            yield mat[i]

    def reshape(self, *shape, order="C"):
        """A matrix of a 2-D shape with the same element count, each entry
        at the same flat position in `order` (scipy's `reshape`; host
        index arithmetic as in the JAX package)."""
        from spmm_tpu_torch.sparse.coo import COO

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if len(shape) != 2:
            raise ValueError("sparse reshape requires a 2-D shape")
        m2, n2 = shape
        m, n = self.shape
        if m2 == -1:
            m2 = (m * n) // n2
        if n2 == -1:
            n2 = (m * n) // m2
        if m2 * n2 != m * n:
            raise ValueError(f"cannot reshape {self.shape} into {shape}")
        if order not in ("C", "F"):
            raise ValueError("order must be 'C' or 'F'")
        coo = self.tocoo()
        row = host(coo.row).astype(np.int64)
        col = host(coo.col).astype(np.int64)
        if order == "C":
            flat = row * n + col
            r2, c2 = flat // n2, flat % n2
        else:
            flat = col * m + row
            r2, c2 = flat % m2, flat // m2
        out = COO((coo.data, (r2, c2)), shape=(int(m2), int(n2)))
        return out.asformat(self.format) if self.format in (
            "csr", "csc", "coo") else out

    def resize(self, shape):
        """Resize in place (scipy's `resize`): entries outside the new shape
        are dropped.  Returns None, as scipy does."""
        from spmm_tpu_torch.sparse.coo import COO

        m2, n2 = int(shape[0]), int(shape[1])
        coo = self.tocoo()
        keep = (coo.row < m2) & (coo.col < n2)
        out = COO((coo.data[keep], (coo.row[keep], coo.col[keep])),
                  shape=(m2, n2)).asformat(self.format)
        self.__dict__.update(out.__dict__)

    # -- scipy bridge (host side) --------------------------------------------

    def to_scipy(self):
        """Host scipy copy, in this format where scipy has it, else CSR."""
        import scipy.sparse as sp

        if self.format == "coo":
            return sp.coo_matrix((host(self.data), (host(self.row),
                                                    host(self.col))),
                                 shape=self.shape)
        a = self if self.format == "csc" else self.tocsr()
        make = sp.csc_matrix if self.format == "csc" else sp.csr_matrix
        return make((host(a.data), host(a.indices), host(a.indptr)),
                    shape=self.shape)

    # -- arithmetic ----------------------------------------------------------

    def __matmul__(self, other):
        from spmm_tpu_torch.ops import dispatch

        _reject_scalar(other)
        return dispatch.matmul(self, other)

    def __rmatmul__(self, other):
        from spmm_tpu_torch.ops import dispatch

        _reject_scalar(other)
        return dispatch.rmatmul(self, other)

    def dot(self, other):
        """scipy's `.dot`: a scalar scales (where `@` refuses it), anything
        else multiplies as `@`."""
        if _is_scalar(other):
            return self * other
        from spmm_tpu_torch.ops import dispatch

        return dispatch.matmul(self, other)

    def __mul__(self, other):
        if _is_scalar(other):
            return self._with_data(self.data * _scalar(other))
        from spmm_tpu_torch.ops import dispatch

        # scipy's `*` on a sparse matrix doubles as matmul
        return dispatch.matmul(self, other)

    def __rmul__(self, other):
        if _is_scalar(other):
            return self._with_data(_scalar(other) * self.data)
        from spmm_tpu_torch.ops import dispatch

        return dispatch.rmatmul(self, other)

    def __truediv__(self, other):
        if _is_scalar(other):
            return self._with_data(self.data / _scalar(other))
        raise NotImplementedError

    def __neg__(self):
        return self._with_data(-self.data)

    def multiply(self, other):
        """Element-wise product."""
        from spmm_tpu_torch.ops import elementwise

        return elementwise.multiply(self, other)

    def __add__(self, other):
        from spmm_tpu_torch.ops import elementwise

        return elementwise.add(self, other)

    def __sub__(self, other):
        from spmm_tpu_torch.ops import elementwise

        return elementwise.add(self, -other)

    # -- reductions ----------------------------------------------------------

    def sum(self, axis=None):
        coo = self.tocoo()
        if axis is None:
            return coo.data.sum()
        if axis in (0, -2):
            return axis_sum(coo.col, coo.data, self.shape[1])
        if axis in (1, -1):
            return axis_sum(coo.row, coo.data, self.shape[0])
        raise ValueError(f"axis out of range: {axis}")

    def mean(self, axis=None):
        m, n = self.shape
        if axis is None:
            return self.sum() / (m * n)
        denom = m if axis in (0, -2) else n
        return self.sum(axis=axis) / denom

    def max(self, axis=None, out=None, *, explicit=False):
        """Maximum, whole-matrix or along an axis.  Implicit zeros take part
        unless `explicit=True`.  Along an axis: a sparse (1, n) / (m, 1) COO
        with the zero results left out."""
        return self._min_or_max(axis, out, "max", explicit)

    def min(self, axis=None, out=None, *, explicit=False):
        """Minimum: see `max`."""
        return self._min_or_max(axis, out, "min", explicit)

    def _min_or_max(self, axis, out, which, explicit):
        if out is not None:
            raise ValueError(
                "Sparse matrices do not support an 'out' parameter.")
        m, n = self.shape
        if axis is None:
            if m == 0 or n == 0:
                raise ValueError("zero-size array to reduction operation")
            data = self.tocoo().data
            zero = torch.zeros((), dtype=self.dtype, device=self.device)
            stored = (data.max() if which == "max" else data.min()) \
                if self.nnz else zero
            if explicit or self.nnz == m * n:
                return stored
            return (torch.maximum if which == "max" else torch.minimum)(
                stored, zero)
        if axis < 0:
            axis += 2
        if axis not in (0, 1):
            raise ValueError(f"axis out of range: {axis}")
        if self.shape[axis] == 0:
            raise ValueError("zero-size array to reduction operation")
        M = self.shape[1 - axis]
        coo = self.tocoo()
        major = host(coo.row if axis == 1 else coo.col)
        data = host(coo.data)
        npop = np.maximum if which == "max" else np.minimum
        red = np.full((M,), -np.inf if which == "max" else np.inf)
        npop.at(red, major, data)
        counts = np.bincount(major, minlength=M)
        value = np.where(counts > 0, red, 0).astype(data.dtype)
        if not explicit:
            # rows/cols with an implicit zero compete against 0
            value = np.where(counts < self.shape[axis],
                             npop(value, np.zeros((), data.dtype)), value)
        return self._vector_as_sparse(value, axis)

    def _vector_as_sparse(self, value, axis):
        """(M,) host vector -> compressed sparse (1, M) or (M, 1) COO."""
        from spmm_tpu_torch.sparse.coo import COO

        (idx,) = np.nonzero(value)
        zeros = np.zeros_like(idx)
        rc = (zeros, idx) if axis == 0 else (idx, zeros)
        shape = (1, len(value)) if axis == 0 else (len(value), 1)
        return COO((torch.from_numpy(value[idx]), rc), shape=shape,
                   device=self.device)

    def argmax(self, axis=None, out=None):
        """Index of the maximum (implicit zeros take part; the first index
        on ties, numpy's rule on the dense form)."""
        return self._arg_min_or_max(axis, out, np.argmax)

    def argmin(self, axis=None, out=None):
        """Index of the minimum: see `argmax`."""
        return self._arg_min_or_max(axis, out, np.argmin)

    def _arg_min_or_max(self, axis, out, npop):
        if out is not None:
            raise ValueError(
                "Sparse matrices do not support an 'out' parameter.")
        m, n = self.shape
        if m == 0 or n == 0:
            raise ValueError("Cannot apply the operation to an empty matrix.")
        arr = host(self.toarray())
        if axis is None:
            return int(npop(arr))
        if axis < 0:
            axis += 2
        if axis not in (0, 1):
            raise ValueError(f"axis out of range: {axis}")
        value = npop(arr, axis=axis)
        return value[None, :] if axis == 0 else value[:, None]

    # -- data ops: functions of the stored values with f(0) == 0 -------------

    def __abs__(self):
        return self._with_data(self.data.abs())

    def abs(self):
        return self.__abs__()

    def power(self, p):
        """Element-wise power of the stored values (scipy's `.power`)."""
        return self._with_data(torch.pow(self.data, p))

    def sqrt(self):
        return self._with_data(torch.sqrt(self.data))

    def log1p(self):
        return self._with_data(torch.log1p(self.data))

    def expm1(self):
        return self._with_data(torch.expm1(self.data))

    def sign(self):
        return self._with_data(torch.sign(self.data))

    def ceil(self):
        return self._with_data(torch.ceil(self.data))

    def floor(self):
        return self._with_data(torch.floor(self.data))

    def rint(self):
        return self._with_data(torch.round(self.data))  # half to even

    def sin(self):
        return self._with_data(torch.sin(self.data))

    def tan(self):
        return self._with_data(torch.tan(self.data))

    def arcsin(self):
        return self._with_data(torch.asin(self.data))

    def arctan(self):
        return self._with_data(torch.atan(self.data))

    def sinh(self):
        return self._with_data(torch.sinh(self.data))

    def tanh(self):
        return self._with_data(torch.tanh(self.data))

    def arcsinh(self):
        return self._with_data(torch.asinh(self.data))

    def arctanh(self):
        return self._with_data(torch.atanh(self.data))

    def deg2rad(self):
        return self._with_data(torch.deg2rad(self.data))

    def rad2deg(self):
        return self._with_data(torch.rad2deg(self.data))

    def trunc(self):
        return self._with_data(torch.trunc(self.data))

    def maximum_scalar(self, s):
        if s > 0:
            raise ValueError("maximum with positive scalar densifies")
        return self._with_data(torch.clamp(self.data, min=s))

    def minimum_scalar(self, s):
        if s < 0:
            raise ValueError("minimum with negative scalar densifies")
        return self._with_data(torch.clamp(self.data, max=s))

    # -- element-wise extrema and comparisons (host, on the dense form) -----

    def _ewise_dense(self, other, np_op, dense_result):
        """maximum/minimum/comparisons with a rhs that is not zero-preserving
        or broadcasts, on the host dense form as in the JAX package.  The
        rhs matches the shape or is (1, n) / (m, 1); anything else raises.
        The result is a tensor on the matrix's device when `dense_result`,
        else a CSR of the nonzero results."""
        m, n = self.shape
        a = host(self.toarray())
        if issparse(other):
            b = host(other.toarray())
        elif np.ndim(other) == 0:
            b = _scalar(other)
        else:
            b = host(other)
            if b.ndim == 1:
                b = b[None, :]
        if np.ndim(b) == 2 and b.shape not in ((m, n), (1, n), (m, 1)):
            raise ValueError(f"inconsistent shapes: {self.shape} vs "
                             f"{b.shape}")
        res = np.ascontiguousarray(np.broadcast_to(np_op(a, b), (m, n)))
        if dense_result:
            return torch.as_tensor(res, device=self.device)
        from spmm_tpu_torch.sparse.coo import COO

        ri, ci = np.nonzero(res)
        return COO((torch.as_tensor(res[ri, ci]), (ri, ci)), shape=(m, n),
                   device=self.device).tocsr()

    def _extremum(self, other, np_op):
        if _is_scalar(other):
            if np_op(np.zeros(1), _scalar(other))[0] == 0:
                # a zero-preserving scalar: stays sparse, on stored values
                torch_op = torch.maximum if np_op is np.maximum \
                    else torch.minimum
                s = torch.as_tensor(_scalar(other), dtype=self.dtype,
                                    device=self.device)
                return self._with_data(torch_op(self.data, s))
            return self._ewise_dense(other, np_op, dense_result=True)
        return self._ewise_dense(other, np_op,
                                 dense_result=not issparse(other))

    def maximum(self, other):
        """Element-wise maximum with a sparse, dense or scalar rhs ((1, n)
        and (m, 1) broadcast).  A positive scalar or a dense rhs gives a
        dense tensor."""
        return self._extremum(other, np.maximum)

    def minimum(self, other):
        """Element-wise minimum: see `maximum`."""
        return self._extremum(other, np.minimum)

    def _comparison(self, other, np_op, op_name):
        if _is_scalar(other):
            zero_true = bool(np_op(np.zeros(1), _scalar(other))[0])
        else:
            zero_true = bool(np_op(np.zeros(1), np.zeros(1))[0])
        if zero_true:
            warnings.warn(
                f"comparing a sparse matrix with {op_name} is inefficient "
                "(the zero background compares True)", stacklevel=3)
        dense_result = zero_true or (not issparse(other)
                                     and not _is_scalar(other))
        return self._ewise_dense(other, np_op, dense_result)

    def __eq__(self, other):
        if other is None:
            return False
        return self._comparison(other, np.equal, "==")

    def __ne__(self, other):
        if other is None:
            return True
        return self._comparison(other, np.not_equal, "!=")

    def __lt__(self, other):
        return self._comparison(other, np.less, "<")

    def __gt__(self, other):
        return self._comparison(other, np.greater, ">")

    def __le__(self, other):
        return self._comparison(other, np.less_equal, "<=")

    def __ge__(self, other):
        return self._comparison(other, np.greater_equal, ">=")

    # defining __eq__ clears the default __hash__; containers hash by
    # identity
    __hash__ = object.__hash__

    @property
    def real(self):
        return self._with_data(torch.real(self.data))

    @property
    def imag(self):
        if self.dtype.is_complex:
            return self._with_data(torch.imag(self.data))
        return self._with_data(torch.zeros_like(self.data))

    def count_nonzero(self) -> int:
        return int((self.data != 0).sum())

    def __repr__(self):
        m, n = self.shape
        return (f"<{m}x{n} sparse matrix of type {self.dtype} with {self.nnz} "
                f"stored elements in {self.format.upper()} format on "
                f"{self.device}>")


def _reject_scalar(other) -> None:
    if _is_scalar(other):
        # scipy's spmatrix.__matmul__ rejects scalars the same way
        raise ValueError("Scalar operands are not allowed, use '*' instead")


def issparse(x) -> bool:
    return isinstance(x, SparseMatrix)


isspmatrix = issparse
