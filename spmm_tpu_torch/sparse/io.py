"""CSR serialization (the cross-process text format and npz) and the
SpMV plans' files.

Port of `spmm_tpu/sparse/io.py`.  The text format is the reference's
cross-check protocol (gen_and_save_alg1_txt.py:8-15, read by the C++
`native/spgemm_cross_check.cpp`): for a matrix `prefix`, the files
`prefix_indptr.txt`, `prefix_indices.txt`, `prefix_data.txt` and
`prefix_shape.txt`, one value per line, ints as `%d` and floats as `%.9g`
(which round-trips float32).  Written from the same values, the files are
byte-identical to the JAX package's, and a file either package saves loads
bitwise in the other; so do the npz files (`format`, `shape`, `indptr`,
`indices`, `data`).

The SpMV plans are the port's own data (SELL-32-sigma slices and chunked
long rows; row-length classes and pieces), not JAX's edge-coloured routes,
though the classes share their names.  Their files carry the marker
`plan_package = "spmm_tpu_torch"` and the port's `PLAN_FORMAT_VERSION`;
the loader refuses a file without the marker (every JAX plan file) and any
other version.  The plans' scratch (`counters`, `partial`) is not saved: a
loaded plan has zeroed counters and fresh scratch.

The loaders put what they load on the card unless `device="cpu"` is given.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch.sparse.base import host, resolve_device
from spmm_tpu_torch.sparse.csr import CSR


def save_csr_txt(prefix: str, a) -> None:
    a = a.tocsr()
    np.savetxt(prefix + "_indptr.txt", host(a.indptr), fmt="%d")
    np.savetxt(prefix + "_indices.txt", host(a.indices), fmt="%d")
    np.savetxt(prefix + "_data.txt", host(a.data), fmt="%.9g")
    with open(prefix + "_shape.txt", "w") as f:
        f.write(f"{a.shape[0]} {a.shape[1]}\n")


def read_csr_txt(prefix: str, shape: Tuple[int, int] = None):
    """(indptr, indices, data, shape) of a text dump as host arrays (int32,
    int32, float32): the shape from `shape`, else the shape file, else
    (rows of indptr, largest column + 1)."""
    indptr = np.loadtxt(prefix + "_indptr.txt", dtype=np.int32, ndmin=1)
    indices = np.loadtxt(prefix + "_indices.txt", dtype=np.int32, ndmin=1)
    data = np.loadtxt(prefix + "_data.txt", dtype=np.float32, ndmin=1)
    if shape is None:
        shape_file = prefix + "_shape.txt"
        if os.path.exists(shape_file):
            with open(shape_file) as f:
                m, n = map(int, f.read().split())
            shape = (m, n)
        else:
            m = len(indptr) - 1
            n = int(indices.max()) + 1 if len(indices) else 0
            shape = (m, n)
    return indptr, indices, data, tuple(shape)


def load_csr_txt(prefix: str, shape: Tuple[int, int] = None,
                 device=None) -> CSR:
    indptr, indices, data, shape = read_csr_txt(prefix, shape)
    return CSR.from_parts(indptr, indices, data, shape, canonical=True,
                          device=device)


def save_npz(path: str, a) -> None:
    a = a.tocsr()
    np.savez_compressed(
        path,
        format="csr",
        shape=np.asarray(a.shape, np.int64),
        indptr=host(a.indptr),
        indices=host(a.indices),
        data=host(a.data),
    )


def load_npz(path: str, device=None) -> CSR:
    with np.load(path) as f:
        return CSR.from_parts(f["indptr"], f["indices"], f["data"],
                              tuple(int(s) for s in f["shape"]),
                              canonical=True, device=device)


def csrs_txt_equal(prefix_a: str, prefix_b: str) -> bool:
    """Bitwise comparison of two text dumps (compare_csrs_txt.py:20-47),
    on the host."""
    a = read_csr_txt(prefix_a)
    b = read_csr_txt(prefix_b)
    return (a[3] == b[3] and np.array_equal(a[0], b[0])
            and np.array_equal(a[1], b[1])
            and np.array_equal(a[2].view(np.uint32), b[2].view(np.uint32)))


# Persisted-plan format of the port, counted from 1.  Bump whenever a
# plan's encoding on disk changes meaning.
PLAN_FORMAT_VERSION = 1
PLAN_PACKAGE = "spmm_tpu_torch"
_SCRATCH = ("counters", "partial")


def _plan_classes():
    from spmm_tpu_torch.ops.kernels.spmv_binned import SpmvBinnedPlan
    from spmm_tpu_torch.ops.kernels.spmv_routed import SpmvRoutedPlan

    return {"routed": SpmvRoutedPlan, "binned": SpmvBinnedPlan}


def save_spmv_plan(path: str, plan) -> None:
    """Save a tagged plan of `spmv_plan` (`("routed", p)` or
    `("binned", p)`): its arrays, its sizes, and the lengths of its
    scratch."""
    tag, p = plan
    cls = _plan_classes().get(tag)
    if cls is None or not isinstance(p, cls):
        raise ValueError(f"save_spmv_plan: expected ('routed', "
                         f"SpmvRoutedPlan) or ('binned', SpmvBinnedPlan), "
                         f"got ({tag!r}, {type(p).__name__})")
    arrays, scalars = {}, {}
    for name, v in zip(p._fields, p):
        if name in _SCRATCH:
            if v is not None:
                scalars[f"len_{name}"] = v.numel()
        elif isinstance(v, torch.Tensor):
            arrays[f"f_{name}"] = v.detach().cpu().numpy()
        elif isinstance(v, tuple):
            arrays[f"f_{name}"] = np.asarray(v, np.int64)
        elif v is not None:
            scalars[name] = int(v)
    names = sorted(scalars)
    np.savez(path, plan_package=PLAN_PACKAGE,
             plan_format_version=np.int64(PLAN_FORMAT_VERSION),
             plan_tag=tag, scalar_names=np.array(names, dtype=str),
             scalar_vals=np.array([scalars[k] for k in names], np.int64),
             **arrays)


def _binned_views(t: dict, m: int, max_pieces: int, dev):
    """The binned plan's (rows, class_off, piece_end, piece_row, counters)
    as views of one int32 buffer, in `spmv_binned_plan`'s order; counters
    zero."""
    from spmm_tpu_torch.ops.kernels.spmv_binned import NCLASSES

    sizes = [m, NCLASSES + 1, m, max_pieces, max_pieces]
    buf = torch.zeros(sum(sizes), dtype=torch.int32, device=dev)
    parts = torch.split(buf, sizes)
    for name, part in zip(("rows", "class_off", "piece_end", "piece_row"),
                          parts):
        part.copy_(t.pop(name))
    return dict(zip(("rows", "class_off", "piece_end", "piece_row",
                     "counters"), parts))


def load_spmv_plan(path: str, device=None):
    """Inverse of `save_spmv_plan`: the tagged plan, on the card unless
    `device="cpu"`.  Raises ValueError for a file that is not the port's
    plan of this format version (a JAX plan file, or another version):
    the kernels read a plan positionally, so a foreign one would compute
    wrong results; re-run `spmv_plan()` and save again."""
    dev = resolve_device(device)
    with np.load(path) as f:
        ver = (int(f["plan_format_version"])
               if "plan_format_version" in f.files else None)
        package = (str(f["plan_package"]) if "plan_package" in f.files
                   else None)
        if package != PLAN_PACKAGE or ver != PLAN_FORMAT_VERSION:
            who = ("this package's" if package == PLAN_PACKAGE
                   else "another package's")
            raise ValueError(
                f"spmv plan at {path!r} is {who} plan of format version "
                f"{ver}; this build reads {PLAN_PACKAGE} plans of format "
                f"version {PLAN_FORMAT_VERSION}; re-run spmv_plan() and "
                f"save again")
        tag = str(f["plan_tag"])
        cls = _plan_classes()[tag]
        scalars = dict(zip((str(s) for s in f["scalar_names"]),
                           (int(v) for v in f["scalar_vals"])))
        tensors = {k[2:]: torch.from_numpy(f[k]).to(dev)
                   for k in f.files if k.startswith("f_")}
    kwargs = {name: scalars[name] for name in cls._fields
              if name in scalars}
    if "classes" in tensors:
        kwargs["classes"] = tuple(int(c) for c in tensors.pop("classes"))
    if tag == "binned":
        tensors.update(_binned_views(tensors, scalars["m"],
                                     scalars["len_counters"], dev))
        tensors["partial"] = torch.empty(scalars["len_partial"],
                                         dtype=torch.float32, device=dev)
    else:
        tensors["counters"] = torch.zeros(scalars["len_counters"],
                                          dtype=torch.int32, device=dev)
        if "len_partial" in scalars:
            tensors["partial"] = torch.empty(scalars["len_partial"],
                                             dtype=torch.float32, device=dev)
    kwargs.update(tensors)
    return (tag, cls(**kwargs))
