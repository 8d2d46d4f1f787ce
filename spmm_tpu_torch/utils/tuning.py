"""Break-even calibration: measure the dense/sparse SpMM crossover on the
card and save the table that `ops.dispatch.break_even_density` reads.

Port of `spmm_tpu/utils/tuning.py` (`calibrate_break_even`,
`load_break_even`).  The JAX version times K data-chained iterations in
one program and subtracts a measured per-call overhead, because its
relay charged ~30 ms a call; here each route is timed by the profiler's
CUDA-event median, one call a sample.

The table is the port's own file, `.break_even_torch.json` at the
repository root.  The JAX package's `.break_even.json` was measured on a
TPU; the port never reads or writes it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import torch

from spmm_tpu_torch.utils.profiler import benchmark, measuring_device

_DEFAULT_CACHE = os.path.join(os.path.dirname(__file__), "..", "..",
                              ".break_even_torch.json")
# columns of the dense operand B, as JAX's calibration
B_COLS = 128
RUNS = 10  # CUDA-event samples per route and cell


def calibrate_break_even(sizes: Sequence[int] = (1024, 2048, 4096, 8192),
                         densities: Sequence[float] = (
                             0.001, 0.003, 0.01, 0.03, 0.1),
                         save_path: Optional[str] = _DEFAULT_CACHE,
                         verbose: bool = True, device=None
                         ) -> Dict[int, float]:
    """For each size, the lowest density of `densities` at which the dense
    SpMM (`_dense_spmm` of A densified once, outside the timed call) is no
    slower than the sparse one (`_csr_spmm`: a per-call plan and
    `spmm_routed`), B being (size, 128) ones; 1.0 where none is.  Returns
    {size: density} and saves it to `save_path` (None: not saved)."""
    import spmm_tpu_torch as pt
    from spmm_tpu_torch.ops.spmm import _csr_spmm, _dense_spmm

    device = measuring_device(device)
    table: Dict[int, float] = {}
    for size in sizes:
        crossover = None
        for density in densities:
            a = pt.random(size, size, density, format="csr", seed=0,
                          device=device)
            b = torch.ones((size, B_COLS), dtype=torch.float32,
                           device=device)
            ad = a.toarray()
            t_sparse = benchmark(_csr_spmm, (a, b), n_repeat=RUNS,
                                 device=device).median_ms
            t_dense = benchmark(_dense_spmm, (ad, b), n_repeat=RUNS,
                                device=device).median_ms
            del ad
            if verbose:
                print(f"n={size} d={density}: sparse {t_sparse:.3f} ms "
                      f"dense {t_dense:.3f} ms")
            if t_dense <= t_sparse and crossover is None:
                crossover = density
        table[size] = crossover if crossover is not None else 1.0
    if save_path:
        with open(save_path, "w") as f:
            json.dump({str(k): v for k, v in table.items()}, f)
        if verbose:
            print(f"saved break-even table to {save_path}")
    return table


def load_break_even(path: Optional[str] = None
                    ) -> Optional[Dict[int, float]]:
    """The saved table as {size: density}, or None where there is none."""
    if path is None:
        path = _DEFAULT_CACHE  # read at call time so tests can repoint it
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    return {int(k): float(v) for k, v in raw.items()}
