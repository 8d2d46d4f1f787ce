#!/usr/bin/env python3
"""Device time of `sddmm`'s torch operations by kernel, on one NVIDIA GPU.

    python3 tools/sddmm_profile.py

At chip_smoke.py's phase-19 cell (S = 4096^2/0.01 from seed 2020, A of
(4096, 64) and B of (64, 4096) N(0,1) from the same seed, alpha 1.5) it
traces 20 calls of each of two forms of the same product with
torch.profiler and prints the kernels by device time, with the card's name
and power limit:

  * `column gather`: B[:, cols].T, the form `ops/sddmm.py` uses;
  * `row gather`: the rows of a contiguous Bᵀ, Bᵀ[cols].

Both gather A's rows the same way and end in the same product, sum and
conversion back to S's format.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu_torch.utils.profiler import card_info  # noqa: E402

CALLS = 20


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sddmm_profile: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    s = pt.random(4096, 4096, 0.01, format="csr", seed=2020, device=dev)
    rng = np.random.default_rng(2020)
    a = torch.from_numpy(rng.standard_normal((4096, 64))
                         .astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((64, 4096))
                         .astype(np.float32)).to(dev)

    def product(b_cols_of):
        coo = s.tocoo()
        a_rows = a[coo.row.long(), :]
        dots = (a_rows * b_cols_of(coo.col.long())).sum(1)
        return coo._with_data(1.5 * (coo.data * dots)).asformat("csr")

    forms = {
        "column gather": lambda: product(lambda c: b[:, c].T),
        "row gather": lambda: product(lambda c: b.T.contiguous()[c]),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    print(f"card: {card_info()}")
    for name, fn in forms.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.name] = (kernels.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / CALLS / 1e3)
        print(f"== {name}: device ms a call {sum(kernels.values()):.4f}")
        for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"   {ms:.4f}  {k[:90]}")


if __name__ == "__main__":
    main()
