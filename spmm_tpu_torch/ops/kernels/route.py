"""Fixed-structure data movement for the serving plans.

Port of `spmm_tpu/ops/kernels/route.py`: `expand_route_plan` /
`densify_routed` (CSR values -> dense) and `compress_route_plan` /
`extract_routed` (dense -> the values of a fixed output structure), when
the sparsity structure is fixed and only the values change per call.

The TPU plans are pairs of static lane-gather tables, because a TPU cannot
scatter or gather across lanes.  The port's plan keeps their idea without
the tables: each entry's flat dense position row*cols + col, computed once
from the structure and put on the plan's device once (int64 for expand;
int32 for compress where the dense output has fewer than 2^31 cells, else
int64: `pos_dtype`).  The expand plan also holds its window table: the
entry offsets of each window of `WINDOW` consecutive flat cells.  On a
CUDA tensor the wrappers launch `csrc/route.cu` (`expand_routed`: one CTA
per window writes the whole window once, zeros included;
`compress_routed`: four entries a thread, a grid the card holds at once;
no atomics); on a CPU tensor they run the plain versions beside them.
Kernel and plain version give the same bits: values are moved, and the
one product (alpha, and beta for the accumulate) is rounded as in the JAX
package.

The TPU gates do not exist here: `m*k % 128`, the VMEM budgets of the
resident source, and the ultra-sparse mask whose 128-entry block spans
more than 128 source rows.  So both plans apply to every structure; only an
empty output structure (cap == 0) has no compress plan, as in JAX.  The
expand plan sorts a structure given out of order (and keeps each entry's
source index); one with a duplicate position raises, since JAX's routing
tables leave such a result undefined.

A plan of a tensor lies on the tensor's device; a plan of a host array goes
to the card unless `device="cpu"` is given, and raises where there is no
card, as the constructors do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.sparse.base import resolve_device

WINDOW = 4096  # flat cells a CTA of expand_routed: 16 KB of float32


class ExpandPlan(NamedTuple):
    """Static plan: CSR values -> dense (m, k) (+ bf16 pattern)."""
    m: int
    k: int
    pos: torch.Tensor    # (nnz,) int64 flat positions row*k + col, rising
    win: torch.Tensor    # (nwin + 1,) int64: entries of window w are
    #                      pos[win[w]:win[w + 1]]
    src: Optional[torch.Tensor] = None  # (nnz,) int64 value index of each
    #                      position; None where the structure was canonical


class CompressPlan(NamedTuple):
    """Static plan: dense (m, n) -> the values of the fixed output
    structure, plus that structure."""
    m: int
    n: int
    cap: int
    pos: torch.Tensor      # (cap,) flat positions, CSR order: pos_dtype
    indptr: torch.Tensor   # (m+1,) int32
    indices: torch.Tensor  # (cap,) int32


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def window_table(pos: np.ndarray, cells: int, w: int) -> np.ndarray:
    """Offsets into the rising positions `pos` of each window of `w`
    consecutive flat cells of a dense array of `cells` cells: window i holds
    pos[table[i]:table[i + 1]]."""
    nwin = -(-int(cells) // w)
    return np.searchsorted(pos, np.arange(nwin + 1, dtype=np.int64) * w)


def expand_route_plan(indptr, indices, m: int, k: int,
                      device=None) -> ExpandPlan:
    """The densify plan of a CSR structure (arrays or tensors), on `device`
    (default: the device of `indices`; a host array's on the card).
    Always applies; raises on a column id outside [0, k) and on a
    duplicate position."""
    ip = _host(indptr).astype(np.int64)
    cols = _host(indices).astype(np.int64)
    dev = resolve_device(device, indices)
    if cols.size and (cols.min() < 0 or cols.max() >= k):
        raise ValueError(f"expand_route_plan: column ids must lie in "
                         f"[0, {k})")
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ip))
    flat = rows * int(k) + cols
    src = None
    if flat.size > 1 and not (np.diff(flat) > 0).all():
        src = np.argsort(flat, kind="stable")
        flat = flat[src]
        if not (np.diff(flat) > 0).all():
            raise ValueError("expand_route_plan: the structure holds a "
                             "duplicate position; sum duplicates first")
    win = window_table(flat, int(m) * int(k), WINDOW)
    return ExpandPlan(int(m), int(k), torch.from_numpy(flat).to(dev),
                      torch.from_numpy(win).to(dev),
                      None if src is None else torch.from_numpy(src).to(dev))


def pos_dtype(m: int, n: int) -> np.dtype:
    """The type of a compress plan's flat positions into an (m, n) dense
    array: int32 where every position fits (m*n < 2^31), else int64."""
    return np.dtype(np.int32 if int(m) * int(n) < 2**31 else np.int64)


def compress_plan_from_flat(flat: np.ndarray, m: int, n: int,
                            device) -> Optional[CompressPlan]:
    """The extraction plan of an output structure given as sorted flat
    positions row*n + col (int64); None when it is empty."""
    cap = int(flat.size)
    if cap == 0:
        return None
    device = torch.device(device)
    lens = np.bincount(flat // n, minlength=m)
    indptr = np.zeros((m + 1,), np.int32)
    np.cumsum(lens, out=indptr[1:])
    return CompressPlan(
        int(m), int(n), cap,
        torch.from_numpy(flat.astype(pos_dtype(m, n))).to(device),
        torch.from_numpy(indptr).to(device),
        torch.from_numpy((flat % n).astype(np.int32)).to(device))


def compress_route_plan(mask, n: int, device=None) -> Optional[CompressPlan]:
    """The extraction plan of an (m, n) output mask (array or tensor), on
    `device` (default: the mask's; a host array's on the card); None when
    the mask is empty."""
    dev = resolve_device(device, mask)
    mask_h = _host(mask)
    flat = np.flatnonzero(mask_h.ravel()).astype(np.int64)
    return compress_plan_from_flat(flat, mask_h.shape[0], n, dev)


def _check_expand(vals: torch.Tensor, plan: ExpandPlan, out) -> None:
    """Raise, worded, on what `densify_routed` does not take."""
    if (vals.dtype != torch.float32 or vals.dim() != 1
            or not vals.is_contiguous()):
        raise ValueError(f"densify_routed: values must be a contiguous 1-D "
                         f"float32 tensor, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if vals.numel() != plan.pos.numel():
        raise ValueError(f"densify_routed: {vals.numel()} values for a plan "
                         f"of {plan.pos.numel()} entries")
    if vals.device != plan.pos.device:
        raise ValueError(f"densify_routed: values are on {vals.device}, the "
                         f"plan on {plan.pos.device}")
    shape = (plan.m, plan.k)
    if out is not None and (out.shape != shape or out.dtype != torch.float32
                            or out.device != vals.device
                            or not out.is_contiguous()):
        raise ValueError(f"densify_routed: out must be a contiguous float32 "
                         f"tensor of shape {shape} on {vals.device}")


def _plan_vals(vals: torch.Tensor, plan: ExpandPlan) -> torch.Tensor:
    """The values in the order of the plan's positions."""
    return vals if plan.src is None else vals[plan.src]


def densify_routed_plain(vals: torch.Tensor, plan: ExpandPlan,
                         emit_pattern: bool = True, out=None):
    """Plain PyTorch version of `expand_routed`, on any device."""
    shape = (plan.m, plan.k)
    dense = (torch.zeros(shape, dtype=torch.float32, device=vals.device)
             if out is None else out.zero_())
    dense.view(-1)[plan.pos] = _plan_vals(vals, plan)
    if not emit_pattern:
        return dense
    pat = torch.zeros(shape, dtype=torch.bfloat16, device=vals.device)
    pat.view(-1)[plan.pos] = 1.0
    return dense, pat


def densify_routed_windows(vals: torch.Tensor, plan: ExpandPlan, w: int,
                           emit_pattern: bool = True):
    """CPU emulation of `expand_routed`'s index arithmetic at window size
    `w`: the window table of the plan's positions, then each window zeroed,
    set from its entries and written out whole.  For tests only."""
    cells = plan.m * plan.k
    table = window_table(plan.pos.cpu().numpy(), cells, w)
    pos = plan.pos.cpu()
    v = _plan_vals(vals, plan).cpu()
    dense = torch.empty(cells, dtype=torch.float32)
    pat = torch.empty(cells, dtype=torch.bfloat16)
    for i in range(table.size - 1):
        e0 = i * w
        n = min(w, cells - e0)
        buf = torch.zeros(w, dtype=torch.float32)
        bits = torch.zeros(w, dtype=torch.bfloat16)
        here = pos[table[i]:table[i + 1]] - e0
        buf[here] = v[table[i]:table[i + 1]]
        bits[here] = 1.0
        dense[e0:e0 + n] = buf[:n]
        pat[e0:e0 + n] = bits[:n]
    dense = dense.view(plan.m, plan.k)
    return (dense, pat.view(plan.m, plan.k)) if emit_pattern else dense


def densify_routed(vals: torch.Tensor, plan: ExpandPlan,
                   emit_pattern: bool = True, out=None):
    """Dense (m, k) f32 from CSR values through the plan, plus (when
    `emit_pattern`) the structural bf16 pattern.  Values are moved bitwise;
    empty cells are +0.0.  `out`, when given, is a (m, k) f32 workspace
    that is overwritten whole (the serving batch reuses one)."""
    # one expression on every call, cheapest first; the worded checks only
    # where it fails
    pos = plan.pos
    dev = vals.get_device()
    shape = (plan.m, plan.k)
    if not (vals.dtype == torch.float32 and vals.shape == pos.shape
            and pos.get_device() == dev and vals.is_contiguous()
            and (out is None or (out.dtype == torch.float32
                                 and out.shape == shape
                                 and out.get_device() == dev
                                 and out.is_contiguous()))):
        _check_expand(vals, plan, out)
        raise ValueError("densify_routed: arguments do not fit the plan")
    if not vals.is_cuda:
        if vals.device.type != "cpu":
            raise ValueError(f"densify_routed: unsupported device "
                             f"{vals.device}")
        return densify_routed_plain(vals, plan, emit_pattern, out)
    empty = not vals.numel()  # no entries: all zeros, nothing to launch
    alloc = torch.zeros if empty else torch.empty
    if out is None:
        out = alloc(shape, dtype=torch.float32, device=vals.device)
    elif empty:
        out.zero_()
    pat = (alloc(shape, dtype=torch.bfloat16, device=vals.device)
           if emit_pattern else None)
    if not empty:
        src = plan.src
        err = _build.launch(dev, "spmm_expand_routed", vals.data_ptr(),
                            pos.data_ptr(),
                            None if src is None else src.data_ptr(),
                            plan.win.data_ptr(), out.data_ptr(),
                            None if pat is None else pat.data_ptr(),
                            plan.m * plan.k, WINDOW)
        _build.check(err, "expand_routed")
        _build.LAUNCHES["expand_routed"] += 1
    return (out, pat) if emit_pattern else out


def _vector_ok(t, cap: int, dev: int) -> bool:
    return (t.dtype == torch.float32 and t.shape == (cap,)
            and t.get_device() == dev and t.is_contiguous())


def _check_compress(c, plan: CompressPlan, c_prev, out) -> None:
    """Raise, worded, on what `extract_routed` does not take."""
    if plan.pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"extract_routed: the plan's positions must be "
                         f"int32 or int64, got {plan.pos.dtype}")
    if (c.dtype != torch.float32 or c.shape != (plan.m, plan.n)
            or not c.is_contiguous()):
        raise ValueError(f"extract_routed: c must be a contiguous float32 "
                         f"tensor of shape {(plan.m, plan.n)}, got {c.dtype} "
                         f"{tuple(c.shape)}")
    if c.device != plan.pos.device:
        raise ValueError(f"extract_routed: c is on {c.device}, the plan on "
                         f"{plan.pos.device}")
    for name, t in (("c_prev", c_prev), ("out", out)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (plan.cap,)
                              or not t.is_contiguous()
                              or t.device != c.device):
            raise ValueError(f"extract_routed: {name} must be a contiguous "
                             f"float32 tensor of shape ({plan.cap},) on "
                             f"{c.device}")


def extract_routed_plain(c: torch.Tensor, plan: CompressPlan, alpha=1.0,
                         c_prev=None, beta=1.0, out=None) -> torch.Tensor:
    """Plain PyTorch version of `compress_routed`, on any device."""
    v = c.view(-1)[plan.pos] * prim.f32(alpha)
    if c_prev is not None:
        v = torch.add(c_prev * prim.f32(beta), v)
    if out is None:
        return v
    return out.copy_(v)


def extract_routed(c: torch.Tensor, plan: CompressPlan, alpha=1.0,
                   c_prev=None, beta=1.0, out=None) -> torch.Tensor:
    """Values of the fixed output structure from dense `c`, in CSR order:
    (alpha * c)[pos], or beta * c_prev + (alpha * c)[pos] when `c_prev` is
    given, each product and the sum rounded to float32 on its own (as the
    JAX serving program computes them).  Written into `out` when given
    (`out` may be `c_prev`: the in-place accumulate)."""
    # one expression on every call, cheapest first; the worded checks only
    # where it fails
    pos = plan.pos
    dev = c.get_device()
    wide = pos.dtype == torch.int64
    if not ((wide or pos.dtype == torch.int32)
            and c.dtype == torch.float32 and c.shape == (plan.m, plan.n)
            and pos.get_device() == dev and c.is_contiguous()
            and (c_prev is None or _vector_ok(c_prev, plan.cap, dev))
            and (out is None or _vector_ok(out, plan.cap, dev))):
        _check_compress(c, plan, c_prev, out)
        raise ValueError("extract_routed: arguments do not fit the plan")
    if not c.is_cuda:
        if c.device.type != "cpu":
            raise ValueError(f"extract_routed: unsupported device {c.device}")
        return extract_routed_plain(c, plan, alpha, c_prev, beta, out)
    if out is None:
        out = c.new_empty(plan.cap)
    if c_prev is None:
        prev, beta = None, 0.0  # the kernel reads beta only with prev
    else:
        prev, beta = c_prev.data_ptr(), prim.f32(beta)
    err = _build.launch(dev, "spmm_compress_routed", c.data_ptr(),
                        pos.data_ptr(), wide, prev, out.data_ptr(), plan.cap,
                        prim.f32(alpha), beta)
    _build.check(err, "compress_routed")
    _build.LAUNCHES["compress_routed"] += 1
    return out
