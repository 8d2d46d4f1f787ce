#!/usr/bin/env python3
"""Time `spmv_binned`, `spmv_onehot`, `spmv(a, x)` and `torch.mv` of one
checkout of the PyTorch/CUDA port on one NVIDIA GPU, or of two checkouts in
turns (A, B, B, A), each turn in a process of its own.

    python3 tools/spmv_turns.py                     # this checkout
    python3 tools/spmv_turns.py --repo DIR          # the checkout at DIR
    python3 tools/spmv_turns.py --against DIR       # DIR, this, this, DIR

Cells: SpMV 16384^2/5e-3 (seed 2014) and the power-law 2^20 matrix
(`power_law_rows(2^20, 2^20, 16, alpha=1.5, seed=0)`), x N(0,1) from seed
2024, as in chip_smoke.py.  Per kernel: `call_ms`, the median CUDA-event
time around one call (the host's wrapper included); `loop_ms`, events
around 200 back-to-back calls over the count; `busy_ms`, the device time
per call in a torch.profiler trace (None where the trace holds no device
events).  Each turn prints one JSON line with the card's name and power
limit.  Needs a CUDA device; imports neither jax nor spmm_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_ms(torch, fn, runs=25, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(torch, fn, calls=200):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def busy_ms(torch, fn, calls=50):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us else None


def measure(repo: str) -> dict:
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    import spmm_tpu_torch as pt
    from spmm_tpu_torch.models import power_law_rows
    from spmm_tpu_torch.ops.kernels import spmv_binned as kb
    from spmm_tpu_torch.ops.kernels import spmv_onehot as ko

    if not torch.cuda.is_available():
        raise SystemExit("spmv_turns: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2024)
    cells = [("spmv 16384^2/5e-3",
              pt.random(16384, 16384, 5e-3, format="csr", seed=2014,
                        device=dev)),
             ("spmv powerlaw 2^20",
              power_law_rows(1 << 20, 1 << 20, 16, alpha=1.5, seed=0,
                             device=dev))]
    out = {"repo": os.path.abspath(pt.__file__), "card": smi}
    for name, a in cells:
        m, n = a.shape
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        args = (a.indptr, a.indices, a.data)
        binned = kb.spmv_binned_plan(*args, m, n)
        onehot = ko.spmv_onehot_plan(a.indptr, m, n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            ta = torch.sparse_csr_tensor(a.indptr.long(), a.indices.long(),
                                         a.data, a.shape)
        calls = {"spmv_binned": lambda: kb.spmv_binned(x, binned),
                 "spmv_onehot": lambda: ko.spmv_onehot(*args, x, m, n,
                                                       onehot),
                 "spmv_call": lambda: pt.spmv(a, x),
                 "torch_mv": lambda: torch.mv(ta, x)}
        row = {"nnz": a.nnz}
        for key, fn in calls.items():
            row[key] = {"call_ms": median_ms(torch, fn),
                        "loop_ms": loop_ms(torch, fn),
                        "busy_ms": busy_ms(torch, fn)}
        out[name] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    if args.against is None:
        print(json.dumps(measure(os.path.abspath(args.repo))), flush=True)
        return
    other = os.path.abspath(args.against)
    for repo in (other, HERE, HERE, other):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--repo",
                        repo], check=True)


if __name__ == "__main__":
    main()
