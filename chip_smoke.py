#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`spmm_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `spmm_tpu_torch/csrc/` (into
`build/spmm_tpu_torch/`), then runs four phases and prints one line of
findings for each:

  0. device and build: torch and CUDA versions, the card's name and power
     limit, the kernels' build time;
  1. each kernel against its plain PyTorch version on the same CUDA tensors,
     bitwise;
  2. the main path, `spgemm(A, B, alg=0)`, at three cells of the reference's
     benchmark grid, held against scipy on the host (structure bitwise,
     values to rtol 1e-6 plus atol 1e-6*max|C|), bitwise on rerun, and with
     every kernel's launch count shown non-zero;
  3. CUDA-event timings (median of 25 runs after warm-up) of the full
     `spgemm`, the serving form `spgemm_fixed(cap=nnz)`, each layer of the
     path, and each kernel against its plain version; the device's busy
     time per `spgemm` from a torch.profiler trace, and its idle share.

Then one JSON line of per-kernel results, and as the last line
`{"ok": true, "device": {...}}`.  Any failure raises and exits non-zero;
so does a machine without CUDA.  It imports neither jax nor spmm_tpu.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

import spmm_tpu_torch as pt
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels.densify_onehot import (densify_onehot,
                                                       densify_onehot_plain)
from spmm_tpu_torch.ops.kernels.extract_roll import (extract_roll,
                                                     extract_roll_plain)

# the module, not the function `spmm_tpu_torch.ops.spgemm` re-exports
sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")

# (name, n, density, seed of A, seed of B): the reference's own cells
# (BASELINE.md:20 headline, :23 dense output, :59 large and sparse)
CELLS = [("1024^2/0.1", 1024, 0.1, 2008, 2009),
         ("1024^2/0.5", 1024, 0.5, 2010, 2011),
         ("8192^2/1e-3", 8192, 1e-3, 2012, 2013)]
RTOL = 1e-6  # the repo's stated error target (BASELINE.json)
RUNS = 25
WARMUP = 3


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a tensor, for bitwise comparison."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(view[t.dtype]) if t.dtype in view else t


def same_bits(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    return x.shape == y.shape and torch.equal(bits(x), bits(y))


def max_abs(x: torch.Tensor, y: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    return float((x.double() - y.double()).abs().max())


def median_ms(fn) -> float:
    """Median over RUNS of CUDA-event time around one call of `fn`."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, calls: int = 10):
    """Device time per call of `fn` from a torch.profiler trace: the sum of
    the device events' durations, and the largest by kernel name.  None if
    the trace holds no device events."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us / calls / 1e3
    if not by_name:
        return None, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return sum(by_name.values()), [[k[:60], v] for k, v in top]


def edge_csr(dev) -> pt.CSR:
    """37x45 CSR with empty rows, an explicit stored zero, and k not a
    multiple of 32."""
    rng = np.random.default_rng(7)
    dense = (rng.random((37, 45)) < 0.3) * rng.random((37, 45))
    dense[[0, 5, 6, 36]] = 0.0
    m = sp.csr_matrix(dense.astype(np.float32))
    m.sort_indices()
    m.data[3] = 0.0  # stored, so structural
    return pt.CSR.from_scipy(m, device=dev)


def phase0():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"card [{smi}], kernels built in {build_s:.2f} s -> "
          f"{lib.relative_to(_build.BUILD_DIR.parents[1])}", flush=True)
    return smi


def make_cells(dev):
    out = []
    for name, n, density, sa, sb in CELLS:
        a = pt.random(n, n, density, seed=sa, device=dev)
        b = pt.random(n, n, density, seed=sb, device=dev)
        out.append((name, a, b))
    return out


def phase1(dev, cells):
    """Kernel against plain version on the card; returns max |err| per
    kernel."""
    err = {"densify_onehot": 0.0, "extract_roll": 0.0}
    notes = []
    mats = [cells[0][1], cells[0][2], edge_csr(dev)]
    for mat in mats:
        for with_pattern in (True, False):
            args = (mat.indptr, mat.indices, mat.data, *mat.shape)
            got = densify_onehot(*args, with_pattern=with_pattern)
            want = densify_onehot_plain(*args, with_pattern=with_pattern)
            if not (same_bits(got[0], want[0]) and same_bits(got[1], want[1])):
                raise AssertionError(f"densify kernel != plain at "
                                     f"{mat.shape} nnz={mat.nnz}")
            err["densify_onehot"] = max(err["densify_onehot"],
                                        max_abs(got[0], want[0]))
    edge = mats[2]
    if edge.toarray().cpu().count_nonzero() >= edge.nnz:
        raise AssertionError("edge case lost its explicit zero")
    notes.append(f"densify bitwise at {len(mats)} operands x 2 modes")
    for name, a, b in cells:
        c, mask, nnz = sg._alg1_dense_compute(a, b, 1.0)
        nnz = int(nnz)
        holes = mask.numel() - nnz
        caps = [nnz] + ([nnz + 100, max(nnz - 100, 0)] if name == CELLS[0][0]
                        else [])
        for cap in caps:
            got = extract_roll(c, mask, cap)
            want = extract_roll_plain(c, mask, cap)
            if not all(same_bits(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"extract kernel != plain at {name} "
                                     f"cap={cap}")
            err["extract_roll"] = max(err["extract_roll"],
                                      max_abs(got[2], want[2]))
        notes.append(f"extract bitwise at {name} g={holes} caps={caps}")
        del c, mask
    torch.cuda.synchronize()
    print("phase 1: " + "; ".join(notes), flush=True)
    return err


def scipy_check(name, a, b, c) -> float:
    """Structure bitwise against scipy's pattern product; values against
    scipy's float64 product.  Returns max |err| / tolerance."""
    a_s, b_s = a.to_scipy(), b.to_scipy()
    ones = [sp.csr_matrix((np.ones(x.nnz), x.indices, x.indptr), x.shape)
            for x in (a_s, b_s)]
    struct = (ones[0] @ ones[1]).tocsr()
    struct.sort_indices()
    indptr = c.indptr.cpu().numpy()
    indices = c.indices.cpu().numpy()
    if not (np.array_equal(indptr, struct.indptr)
            and np.array_equal(indices, struct.indices)):
        raise AssertionError(f"{name}: structure differs from scipy")
    ref = (a_s.astype(np.float64) @ b_s.astype(np.float64)).tocsr()
    rows = np.repeat(np.arange(c.shape[0]), np.diff(indptr))
    want = np.asarray(ref[rows, indices.astype(np.int64)]).ravel()
    got = c.data.cpu().numpy().astype(np.float64)
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    scale = np.abs(want).max() if want.size else 0.0
    tol = RTOL * np.abs(want) + RTOL * scale
    ratio = float((np.abs(got - want) / np.maximum(tol, 1e-300)).max()
                  if want.size else 0.0)
    if ratio > 1.0:
        raise AssertionError(f"{name}: values off scipy by {ratio:.3g}x the "
                             f"tolerance")
    return ratio


def phase2(cells):
    """The main path at every cell; returns per-kernel launch counts and
    the output nnz per cell."""
    outs = []
    _build.reset_launches()
    for name, a, b in cells:
        outs.append((pt.spgemm(a, b, alg=0), pt.spgemm(a, b, alg=0)))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # 2 runs x 2 operands densified, 2 runs x 1 extraction, per cell
    want = {"densify_onehot": 4 * len(cells), "extract_roll": 2 * len(cells)}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    notes, nnzs = [], {}
    for (name, a, b), (c1, c2) in zip(cells, outs):
        if c1.shape != (a.shape[0], b.shape[1]) or not c1.has_canonical_format:
            raise AssertionError(f"{name}: bad output {c1}")
        if not (same_bits(c1.indptr, c2.indptr)
                and same_bits(c1.indices, c2.indices)
                and same_bits(c1.data, c2.data)):
            raise AssertionError(f"{name}: rerun is not bitwise identical")
        ratio = scipy_check(name, a, b, c1)
        nnzs[name] = c1.nnz
        notes.append(f"{name} nnz={c1.nnz} err/tol={ratio:.3g} rerun bitwise")
    print(f"phase 2: launches {launches}; " + "; ".join(notes), flush=True)
    return launches, nnzs


def phase3(cells, nnzs, smi):
    """CUDA-event medians per cell; returns the table rows."""
    rows = []
    for name, a, b in cells:
        m, k = a.shape
        n = b.shape[1]
        cap = nnzs[name]
        ad, a_pat = densify_onehot(a.indptr, a.indices, a.data, m, k)
        bd, b_pat = densify_onehot(b.indptr, b.indices, b.data, k, n)
        c, mask, _ = sg._alg1_dense_compute(a, b, 1.0)
        dens_args = (a.indptr, a.indices, a.data, m, k)

        def value_gemm():
            with sg._ieee_fp32_matmul():
                torch.matmul(ad, bd)

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pt.spgemm(a, b, alg=0)
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        row = {
            "cell": name,
            "spgemm_ms": median_ms(lambda: pt.spgemm(a, b, alg=0)),
            "spgemm_fixed_ms": median_ms(
                lambda: pt.spgemm_fixed(a, b, cap=cap)),
            "densify_ms": median_ms(lambda: densify_onehot(*dens_args)),
            "densify_plain_ms": median_ms(
                lambda: densify_onehot_plain(*dens_args)),
            "value_gemm_ms": median_ms(value_gemm),
            "count_gemm_ms": median_ms(lambda: torch.matmul(a_pat, b_pat)),
            "extract_ms": median_ms(lambda: extract_roll(c, mask, cap)),
            "extract_plain_ms": median_ms(
                lambda: extract_roll_plain(c, mask, cap)),
            "spgemm_peak_mb": peak_mb,
        }
        busy, top = device_profile(lambda: pt.spgemm(a, b, alg=0))
        row["spgemm_device_busy_ms"] = busy
        row["spgemm_idle_share"] = (None if busy is None
                                    else 1.0 - busy / row["spgemm_ms"])
        row["spgemm_device_top_ms"] = top
        if name == CELLS[0][0]:
            # comparator only, never on the port's path: torch's own
            # (cuSPARSE) CSR @ CSR
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # beta notices
                ta, tb = (torch.sparse_csr_tensor(x.indptr.long(),
                                                  x.indices.long(), x.data,
                                                  x.shape) for x in (a, b))
                row["torch_csr_matmul_ms"] = median_ms(lambda: ta @ tb)
        rows.append(row)
        del ad, bd, a_pat, b_pat, c, mask
        print(f"phase 3 [{smi}]: " + json.dumps(row), flush=True)
    return rows


def main():
    smi = phase0()
    dev = torch.device("cuda", 0)
    cells = make_cells(dev)
    err = phase1(dev, cells)
    launches, nnzs = phase2(cells)
    rows = phase3(cells, nnzs, smi)
    head = rows[0]
    kernels = [
        {"name": "densify_onehot", "route": "cuda",
         "source": "spmm_tpu_torch/csrc/densify.cu",
         "replaces": "spmm_tpu/ops/kernels/densify_onehot.py:309",
         "launches": launches["densify_onehot"],
         "max_abs_err": err["densify_onehot"],
         "ms": head["densify_ms"], "plain_ms": head["densify_plain_ms"]},
        {"name": "extract_roll", "route": "cuda",
         "source": "spmm_tpu_torch/csrc/extract.cu",
         "replaces": "spmm_tpu/ops/kernels/extract_roll.py:123",
         "launches": launches["extract_roll"],
         "max_abs_err": err["extract_roll"],
         "ms": head["extract_ms"], "plain_ms": head["extract_plain_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
