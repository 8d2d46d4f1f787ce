"""Dense product under a structural mask -> CSR, kept cells in row-major
order.

Port of `spmm_tpu/ops/kernels/extract_roll.py::extract_roll`, and with it of
every extraction route of `spmm_tpu/ops/spgemm.py` (`_extract_full`,
`_extract_shift`, `_extract_sort`): all four give the same output, so one
kernel serves every hole count.  On a CUDA tensor the wrapper makes one C
call to `csrc/extract.cu` (a memset of the look-back's status words, then
one pass over the flat mask in tiles of 4096 or 16384 cells with a
decoupled look-back scan); on a CPU tensor it runs `extract_roll_plain`.
`extract_roll_tiles` and `lookback_prefixes` emulate the kernel's index
arithmetic on the CPU, for the tests.

The values may be of any dtype of 2, 4, 8 or 16 bytes (bfloat16, float32,
float64, complex64, complex128, ...): the kernel moves each as one item of
its width, so every width is bitwise its plain version.

`cap` is the length of the returned `col`/`vals`: slots past the kept
count are zero, and kept cells past `cap` are dropped.  `indptr` is not
clamped (the caller clamps, as `_alg1_fixed` does).  The JAX function's
`g_pad` bucket only sizes its roll plan and has no counterpart here.
Bound on the card: bytes (the mask read once, kept values once, col, vals
and indptr written once: 1 byte a cell, 8 + w a kept cell of w bytes).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build

# mask cells a tile of the kernel: 16 or 64 a thread; a large mask takes
# the larger tiles (fewer CTAs, more loads in flight in each)
TILE_CELLS = (4096, 16384)
LARGE_MASK = 1 << 24
# bytes of a value item the kernel moves (csrc/extract.cu's instances)
WIDTHS = (2, 4, 8, 16)


def tile_cells(cells: int) -> int:
    """The kernel's tile size for a mask of `cells` cells (read at each
    call: tests and tools lower LARGE_MASK to drive the larger tiles)."""
    return TILE_CELLS[cells >= LARGE_MASK]


def _indptr(counts: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(1, dtype=prim.INDEX_DTYPE, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, 0, dtype=prim.INDEX_DTYPE)])


def extract_roll_plain(c: torch.Tensor, mask: torch.Tensor, cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device."""
    n = c.shape[1]
    indptr = _indptr(mask.sum(1, dtype=prim.INDEX_DTYPE))
    flat = torch.nonzero(mask.reshape(-1)).squeeze(1)[:cap]
    col = torch.zeros(cap, dtype=prim.INDEX_DTYPE, device=c.device)
    vals = torch.zeros(cap, dtype=c.dtype, device=c.device)
    col[:flat.numel()] = (flat % n).to(prim.INDEX_DTYPE)
    vals[:flat.numel()] = c.reshape(-1)[flat]
    return indptr, col, vals


def extract_roll_tiles(c: torch.Tensor, mask: torch.Tensor, cap: int,
                       tile: int, per_thread: int = None):
    """CPU emulation of the kernel's index arithmetic at `tile` cells a
    tile, cut into runs of `per_thread` cells (a thread's; default: one
    run a tile): per-tile counts of the flat mask and their exclusive scan;
    in each tile the runs' counts and their exclusive scan; each kept
    cell's slot (tile prefix + run prefix + rank in the run); indptr[r]
    from the run holding flat cell r*n.  For tests only."""
    m, n = c.shape
    total = m * n
    if total == 0:
        return extract_roll_plain(c.cpu(), mask.cpu(), cap)
    run = per_thread or tile
    if tile % run:
        raise ValueError("extract_roll_tiles: per_thread must divide tile")
    ntiles = -(-total // tile)
    flat = torch.zeros(ntiles * tile, dtype=torch.bool)
    flat[:total] = mask.reshape(-1).cpu()
    runs = flat.view(ntiles, tile // run, run).to(torch.int64)
    in_run = runs.sum(2)                              # (ntiles, runs)
    counts = in_run.sum(1)
    prefix = torch.cumsum(counts, 0) - counts         # exclusive, tiles
    run_prefix = torch.cumsum(in_run, 1) - in_run     # in the tile
    rank = torch.cumsum(runs, 2) - runs               # kept before, run
    slot = (prefix[:, None, None] + run_prefix[:, :, None]
            + rank).reshape(-1)
    starts = torch.arange(m, dtype=torch.int64) * n
    indptr = torch.empty(m + 1, dtype=prim.INDEX_DTYPE)
    indptr[:m] = slot[starts].to(indptr.dtype)
    indptr[m] = int(prefix[-1] + counts[-1])
    slot = slot[:total]
    keep = flat[:total] & (slot < cap)
    cells = torch.nonzero(keep).squeeze(1)
    col = torch.zeros(cap, dtype=prim.INDEX_DTYPE)
    vals = torch.zeros(cap, dtype=c.dtype)
    col[slot[cells]] = (cells % n).to(prim.INDEX_DTYPE)
    vals[slot[cells]] = c.reshape(-1).cpu()[cells]
    return indptr, col, vals


def lookback_prefixes(counts, lanes: int = 32, seed: int = 0):
    """CPU emulation of the kernel's decoupled look-back: tiles take
    tickets in order and run interleaved at random; each publishes its
    count ("aggregate"), reads the status words of up to `lanes` tiles
    before it at a time (retrying while one it needs is unpublished) and
    adds them up to the nearest inclusive prefix, then publishes its own.
    Returns each tile's exclusive prefix.  For tests only."""
    rng = np.random.default_rng(seed)
    counts = [int(x) for x in counts]
    nt = len(counts)
    flag = [0] * nt       # 0 unpublished, 1 aggregate, 2 inclusive prefix
    value = [0] * nt
    look = [t - 1 for t in range(nt)]
    prefix = [0] * nt
    state = [0] * nt      # 0 not started, 1 looking back, 2 done
    started = 0
    while state.count(2) < nt:
        live = [t for t in range(nt) if state[t] == 1]
        if started < nt and (not live or rng.random() < 0.5):
            t, started = started, started + 1  # the next ticket
            if t == 0:
                flag[0], value[0], state[0] = 2, counts[0], 2
            else:
                flag[t], value[t], state[t] = 1, counts[t], 1
            continue
        t = live[rng.integers(len(live))]
        window = [(flag[i], value[i]) if i >= 0 else (2, 0)
                  for i in range(look[t], look[t] - lanes, -1)]
        first = next((j for j, (f, _) in enumerate(window) if f == 2),
                     None)
        need = window if first is None else window[:first + 1]
        if any(f == 0 for f, _ in need):
            continue  # spin: a tile it needs has not published
        prefix[t] += sum(v for _, v in need)
        if first is None:
            look[t] -= lanes
            continue
        flag[t], value[t], state[t] = 2, prefix[t] + counts[t], 2
    return prefix


def _check(c: torch.Tensor, mask: torch.Tensor, cap: int) -> None:
    """Raise, worded, on what `extract_roll` does not take."""
    if (c.element_size() not in WIDTHS or c.dtype == torch.bool
            or c.dim() != 2 or not c.is_contiguous()):
        raise ValueError(f"extract_roll: c must be a contiguous 2-D tensor "
                         f"of 2, 4, 8 or 16-byte elements, got {c.dtype} "
                         f"{tuple(c.shape)}")
    if (mask.dtype != torch.bool or mask.shape != c.shape
            or not mask.is_contiguous()):
        raise ValueError(f"extract_roll: mask must be a contiguous bool "
                         f"tensor of shape {tuple(c.shape)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != c.device:
        raise ValueError(f"extract_roll: mask is on {mask.device}, c on "
                         f"{c.device}")
    if not 0 <= cap < 2**31:
        raise ValueError(f"extract_roll: cap {cap} outside [0, 2^31)")
    if c.numel() >= 2**31:
        raise ValueError(f"extract_roll: {tuple(c.shape)} has more cells "
                         "than an int32 indptr can count")


def extract_roll(c: torch.Tensor, mask: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSR (indptr, col, vals) of the kept cells of dense `c` under `mask`,
    in row-major order, with `col`/`vals` of length `cap`."""
    # one expression on every call, cheapest first; the worded checks only
    # where it fails
    dev = c.get_device()
    width = c.element_size()
    if not (width in WIDTHS and mask.dtype == torch.bool
            and c.dim() == 2 and mask.shape == c.shape
            and mask.get_device() == dev and 0 <= cap < 2**31
            and c.numel() < 2**31 and c.is_contiguous()
            and mask.is_contiguous()):
        _check(c, mask, cap)
        raise ValueError("extract_roll: arguments do not fit")
    if not c.is_cuda:
        if c.device.type != "cpu":
            raise ValueError(f"extract_roll: unsupported device {c.device}")
        return extract_roll_plain(c, mask, cap)
    m, n = c.shape
    # no cell: nothing is kept, and nothing to launch
    alloc = torch.empty if m * n else torch.zeros
    indptr = alloc(m + 1, dtype=prim.INDEX_DTYPE, device=c.device)
    col = alloc(cap, dtype=prim.INDEX_DTYPE, device=c.device)
    vals = alloc(cap, dtype=c.dtype, device=c.device)
    if not m * n:
        return indptr, col, vals
    tile = tile_cells(m * n)
    # the ticket and one status word a tile, zeroed by the C entry
    ws = torch.empty(-(-m * n // tile) + 1, dtype=torch.int64,
                     device=c.device)
    err = _build.launch(dev, "spmm_extract_roll", c.data_ptr(),
                        mask.data_ptr(), ws.data_ptr(), indptr.data_ptr(),
                        col.data_ptr(), vals.data_ptr(), m, n, cap, tile,
                        width)
    _build.check(err, "extract_roll")
    _build.LAUNCHES["extract_roll"] += 1
    return indptr, col, vals
