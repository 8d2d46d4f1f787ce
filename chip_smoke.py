#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`spmm_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `spmm_tpu_torch/csrc/` (into
`build/spmm_tpu_torch/`), then runs twenty-three phases and prints findings
for each:

  0. device and build: torch and CUDA versions, the card's name and power
     limit, the kernels' build time;
  1. each kernel against its plain PyTorch version on the same CUDA tensors,
     bitwise and on rerun; `densify_onehot` at A and B of 1024^2/0.1, A of
     8192^2/1e-3 and at the edges of its 4096-cell windows (k = 1, 3,
     4095, 4097, 9001, m*k not a multiple of the window, empty rows and
     stored zeros); `extract_roll` also at the edges of its one-pass design
     (rows wider than a tile, n = 1, 3, 15, 17, m = 1, all-false and
     all-true masks, a mask off 16-byte alignment) at five caps each, and
     bitwise on rerun;
  2. the main path, `spgemm(A, B, alg=0)`, at three cells of the reference's
     benchmark grid, held against scipy on the host (structure bitwise,
     values to rtol 1e-6 plus atol 1e-6*max|C|), bitwise on rerun, and with
     every kernel's launch count shown non-zero;
  3. CUDA-event timings (median of 25 runs after warm-up) of the full
     `spgemm`, the serving form `spgemm_fixed(cap=nnz)`, each layer of the
     path, and each kernel against its plain version (`extract_roll` and
     `densify_onehot` also per call of 200 back to back and by their device
     times); the device's busy
     time per `spgemm` from a torch.profiler trace, and its idle share;
  4. the four SpMV/SpMM kernels against their plain versions and scipy's
     float64 product, per row within 1e-6 of the row's absolute sum
     (|A|@|x|)_i, at five cells (SpMV 1024^2/0.1, 16384^2/5e-3 and a
     2^20-row power-law matrix; SpMM 10000^2/0.01 and the power-law matrix,
     k = 64) and at the SpMV edges (rows spanning many chunks between empty
     leading and trailing rows, rows of several binned pieces, an all-empty
     matrix, m = 1, the 37x45 edge CSR), `spmv_onehot` at every chunk size
     there, `spmm_routed` there and at a full row of 9000 entries at k = 1,
     33, 45, 64, 128, on an X aligned to 16 bytes and one that is not, over
     both kinds of plan at the default cut and at cut 8 with chunks of 16,
     each bitwise on rerun; `segment_sum` bitwise against its plain
     version on the CPU at the power-law matrix's rows;
  5. the SpMV/SpMM entry points (`spmv` per call and with each tagged plan,
     `spmv(transa=True)`, `spmm` per call and with the routed plan,
     `A @ x`, `A @ X`) at those cells and edges against scipy, bitwise on
     rerun, and `sum(axis=1)` of the power-law matrix and `diagonal()`
     bitwise the CPU's, with every kernel's launch count as expected;
  6. their CUDA-event timings: each kernel against its plain version and
     `torch.mv` (cuSPARSE) in turns (`spmv_binned`, `spmv_onehot` and
     `spmv_routed`), per call (an event pair around one call, the host's
     wrapper included) and per call of 200 back to back, the kernels'
     device busy time from a profiler trace (`spmv_routed`'s by kernel
     name too), each cell's bound,
     `spmv_onehot` at chunk sizes 1024-4096, `spmv` by plan tag and end to
     end, plan builds on the host clock, Gnnz/s and G MAC/s; `spmm_routed`
     at both SpMM cells per call, per call of 200 back to back and by its
     device time over both kinds of plan, beside torch's CSR @ dense, with
     each cell's bytes-once bound and the bytes its gathers of X move; the
     device's
     busy time and idle share; `diagonal()`, `sum(axis=1)` and
     `segment_sum` beside its plain version and `torch.segment_reduce`;
  7. fixed-structure serving, `spgemm_plan(A, B)`, at SpGEMM 1024^2/0.1,
     8192^2/1e-3 and an edge pair (explicit zeros, empty rows and columns)
     plus an empty output: `expand_routed` / `compress_routed` bitwise
     against their plain versions (the fused accumulate form included, also
     written in place; `compress_routed` with the plan's int32 positions
     and with int64 ones; `expand_routed` also at the edges of its windows,
     plans of host arrays made on the card by default: rows wider than a
     window, m = 1, k = 1, 3, 15, 17, a structure out of order, into a
     workspace and into one off 16-byte alignment);
     plan calls against scipy, bitwise on rerun, with fresh values on the
     same structure, `values_accumulate`, `values_batch` (K = 8, each row
     bitwise a single call) and launch counts; whether the plan's output
     is bitwise `spgemm(alg=1)`'s on the card, else the largest ulp gap;
  8. the ESC engine, `spgemm(alg=2/3, impl="esc")` with chunk fractions
     0.2 and 0.05, at 1024^2/0.1 and 1024^2/0.5: against scipy, alg2 ==
     alg3 bitwise, bitwise on rerun, and at 1024^2/0.1 bitwise against the
     port's own CPU run of the same calls;
  9. their CUDA-event timings: plan call, `values`, `values_batch` per
     multiply, plan build (host clock), each routed kernel against its
     plain version (`expand_routed` also per call of 200 back to back and
     by its device time), `compress_routed` beside `torch.take` in turns, per
     call, per call of 200 back to back and by the profiler's device time,
     with its bound (c counted in the 32-byte sectors it touches),
     `spgemm(alg=1)` and `spgemm_fixed` beside them, the device's busy time
     and idle share; ESC alg2/alg3 times and the peak-memory increase of
     one alg1/alg2/alg3 call;
 10. the blocked engines, `spgemm(alg=2)` and `spgemm(alg=3,
     chunk_fraction=0.2 and 0.05)` with the default `impl`, at the three
     cells of phase 2 and the edge pairs of phase 7: `densify_onehot_pattern`
     bitwise against its plain version, every call against scipy and
     bitwise on rerun, the engine each call took, launch counts of the
     three kernels of the path; at 1024^2/0.1 the two alg2 and the four alg3
     engines forced, each set bitwise within itself;
 11. their timings at those cells: CUDA-event medians of alg1, each alg2
     and alg3 engine and ESC, each with its peak-memory increase and host
     syncs per call; the count and numeric passes apart; device busy time
     and idle share; `densify_onehot_pattern` against its plain version and
     torch's CSR `to_dense()`, with its device time from a profiler trace,
     also at the (k, P n_b) pattern of B in the cf 0.2 alg3 sizing pass;
 12. the containers slice: `bsr_spmm` against its plain version (within
     1e-6 of each entry's absolute sum, bitwise on rerun; each cell's worst
     ratio to that gate, and the kernel's against scipy) at four block
     cells (128x128 blocks of `models.block_sparse`, X of 256 columns), a
     CSR 8192^2/1e-3 re-tiled by `tobsr()` at (8, 128) and three edges;
     `csr_densify_mxu` bitwise against its plain version and `toarray()`;
     the main path with launch counts: `spmm(via="bsr_pallas")`,
     `spmm(via="bsr")`, `spmm(A_bsr, X)` and `A_bsr @ X` against scipy's
     float64 product, and `csr_densify_mxu`; full-size round trips
     COO/CSR/CSC/BSR/DIA bitwise against scipy's conversions;
 13. their CUDA-event timings: each kernel, its plain version and torch's
     library call (BSR @ dense, CSR `to_dense()`), spmm's two BSR routes,
     `bsr_spmm`'s device time and its bound on its own route (3xTF32 on the
     tensor cores) beside the FMA units' bound,
     `tobsr()`, `tocoo().tocsr()` and `tocsc()`, and the device's busy
     time and idle share for `spmm(via="bsr_pallas")`;
 14. indexing on the card at 4000^2/0.0625 (about 1 M entries) and the
     SpMV 16384^2/5e-3 matrix: a row slice, a row array, a column slice,
     every 7th column, a boolean row mask, pair extraction, a submatrix
     assignment and `setdiag`, each bitwise the port's own CPU result for
     the same call, with its CUDA-event time;
 15. dtypes: `densify_onehot` and `extract_roll` bitwise against their
     plain versions at every element width (bfloat16, float32, float64,
     complex64, complex128) and at phase 1's edges; alg1 and blocked alg2
     at 1024^2/0.1 in each of those dtypes against scipy at the JAX dtype
     tests' tolerances, with both kernels seen in a profiler trace of the
     wide alg1 call and their device times at each width; SpMV and SpMM in
     float64 at 16384^2/5e-3 against scipy; times beside float32's;
 16. the precision modes "highest", "high" (3xTF32) and "default" (one
     TF32 pass) at 1024^2/0.1 and 8192^2/1e-3, for alg1 and a serving
     plan: time a call, device busy, the value GEMM's share, and the error
     against scipy's float64 product (max |dC| / max|C| and the share of
     entries outside the 1e-6 gate); "high" must pass the gate of
     "highest", "default" only 1e-2 max|C|;
 17. the headline, `spmm_tpu_torch.bench`'s measurement in-process: one
     `_alg1_fixed` call at 1024^2/0.1 captured as a CUDA graph, checked
     bitwise against an eager call, replayed 100 times between one event
     pair (`value`), beside the per-call, full-pipeline, cuSPARSE and
     device-busy times;
 18. `calibrate_break_even` over its default grid into
     `build/break_even_torch.json`; with the table in force,
     `matmul(mode="auto")` takes the dense route at the crossover and the
     sparse one below it, by launch counts, against scipy;
 19. `sddmm` at 4096^2/0.01 (k = 64), at an empty S and at k = 1 against
     scipy's float64 per entry within 1e-6 |alpha||s|(|A||B|)_ij, bitwise
     on rerun, timed beside `torch.sparse.sampled_addmm`; a card matrix
     through the text and npz files and back bitwise; routed and binned
     SpMV plans of 16384^2/5e-3 saved, loaded onto the card, and their
     SpMV bitwise the built plans' twice;
 20. the experiment suites on the card: `experiments.deterministic` (sizes 32-1024,
     densities 0.01-0.3, seed 1, algs 1-3: six processes) must say ALL
     DETERMINISTIC, and `experiments.cross_check` must pass all 45 cases
     of the reference's grid;
 21. the speed drivers' `main()` on the card through `--json` at small
     grids, in a process of its own (this script with `--phase-21`, as a
     driver runs from the command line): `alg_comparison` (1024^2/0.1 and
     512^2/0.5, algs 1-3, `--memory`, `--device-loop`), `dense_vs_sparse`
     (1024 and 2048 x 0.001/0.01/0.1), `spgemm_vs_spmv` (512^2/0.1),
     `component_profile` (1024^2/0.1) and `numerical_error` (`error` at
     256/512 x 0.1/0.5, `fraction --ref f64` at 512^2/0.1): every row its
     grid implies, with positive times, busy times included; the alg 1-3
     products of each alg_comparison cell of one structure, bitwise, and
     within the SpGEMM gate of scipy; every max |C1 - C3| within 1e-6
     max|C|; each driver's kernel launches (counts set to 0 just before
     it, read just after) and the hand-written kernels a profiler trace of
     its path shows, each kernel the path must launch among them;
 22. distribution (`spmm_tpu_torch.parallel`) at world size 1 under NCCL
     on cuda:0, in a process of its own (`--phase-22`; one card cannot
     hold two NCCL ranks, so this shows no scaling): `spmv_sharded` and
     `spmv_t_sharded` at SpMV 16384^2/5e-3, `spmm_sharded` at SpMM
     10000^2/0.01 (k = 64), `spgemm_dense_sharded`, `spgemm_sharded_sparse`
     (ring and all-gather) and SUMMA on a 1x1 mesh at 8192^2/1e-3 (seeds
     2012/2013), the streamed and blocked SpMV at 2^20/5e-7, and every
     sparse and dense collective on the SpMV matrix: each within 1e-6 of
     the single-card `spmv`, `spmm` or `spgemm(alg=1)`, the sparse
     SpGEMM's structure bitwise alg1's, the streamed SpMV bitwise its
     blocked twin, each collective's output bitwise its input; launch
     counts over the path, `densify_onehot`, `extract_roll` and
     `segment_sum` in a profiler trace, and NCCL's all_gather,
     all_to_all, broadcast, scatter and all_reduce in another; ms a call,
     busy ms and peak MB per op.

Then the card's name and power limit, one JSON line of per-kernel results
(time, plain version's time, launches on the main path, the least time the
card could take for the same work and what bounds it, and the time of one
PyTorch library call computing the same function, where there is one) for
the eleven TPU kernels' counterparts and the port's own `spmv_binned_plan`
and `segment_sum` (phase 22's launches added to those of the kernels it
runs), and
as the last line `{"ok": true, "device": {...}}`.  Any failure raises and
exits non-zero;
so does a machine without CUDA.  It imports neither jax nor spmm_tpu.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

import spmm_tpu_torch as pt
from spmm_tpu_torch.models import banded, block_sparse, power_law_rows
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
from spmm_tpu_torch.ops.kernels.densify_mxu import (
    _launch as densify_mxu_launch, csr_densify_mxu, csr_densify_mxu_plain)
from spmm_tpu_torch.ops.kernels.densify_onehot import (
    densify_onehot, densify_onehot_pattern, densify_onehot_pattern_plain,
    densify_onehot_plain)
from spmm_tpu_torch.ops.kernels.extract_roll import (extract_roll,
                                                     extract_roll_plain)
from spmm_tpu_torch.ops.kernels import segment_sum as ks
from spmm_tpu_torch.ops.kernels import spmv_binned as kb
from spmm_tpu_torch.ops.kernels import spmv_onehot as ko
from spmm_tpu_torch.ops.kernels import spmv_routed as kr

# the module, not the function `spmm_tpu_torch.ops.spgemm` re-exports
sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
bl = importlib.import_module("spmm_tpu_torch.ops.spgemm_blocked")

# (name, n, density, seed of A, seed of B): the reference's own cells
# (BASELINE.md:20 headline, :23 dense output, :59 large and sparse)
CELLS = [("1024^2/0.1", 1024, 0.1, 2008, 2009),
         ("1024^2/0.5", 1024, 0.5, 2010, 2011),
         ("8192^2/1e-3", 8192, 1e-3, 2012, 2013)]
RTOL = 1e-6  # the repo's stated error target (BASELINE.json)
RUNS = 25
WARMUP = 3
# the card's rates for the least time of a kernel's work (NVIDIA's H100 SXM
# data sheet, dense): HBM bytes/s, float32 outside the tensor cores, TF32 on
# the tensor cores (989.4 TFLOP/s with sparsity, half of it dense)
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 494.7e12


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


def median_ms(fn, runs: int = RUNS, warmup: int = WARMUP) -> float:
    """Median over `runs` of CUDA-event time around one call of `fn`."""
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


def bound(nbytes: int, flops: int = 0, rate: float = FP32_FLOPS):
    """(least ms, "bytes" or "operations"): the larger of the bytes the work
    must move over the HBM rate and its operations over `rate` (float32
    outside the tensor cores unless said)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def torch_csr(indptr, indices, values, shape):
    """torch's own sparse CSR tensor of the same arrays (a comparator off
    the port's path)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # beta notices
        return torch.sparse_csr_tensor(indptr.long(), indices.long(), values,
                                       shape)


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


def kernel_ms(fn, name: str):
    """Device time of one launch of the kernel whose name holds `name`: the
    mean duration of its events in a torch.profiler trace of 50 calls of
    `fn`, or of 200 where that trace came back without them (robust to a
    trace that misses some events); None if neither holds any."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for calls in (50, 200):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


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


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase0():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    smi = card_line()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"card [{smi}], kernels built in {build_s:.2f} s -> "
          f"{lib.relative_to(_build.BUILD_DIR.parents[1])}", flush=True)
    ptxas = (ptxas_summary(_build.PTXAS_REPORT)
             or ["no report: the library came from an earlier build"])
    print("phase 0: ptxas " + "; ".join(ptxas), flush=True)
    return smi


def ptxas_summary(reports):
    """'kernel: N registers, S bytes spilled' per kernel of the build's
    `ptxas -v` output (empty when the library came from an earlier
    build)."""
    out, name, spill = [], None, "0"
    for line in "\n".join(reports).splitlines():
        if "Function properties for" in line:
            name, spill = line.split("for", 1)[1].strip(), "0"
            # a kernel in an anonymous namespace mangles as
            # _ZN<len>_GLOBAL__N__<hash>_<file>_cu_<hash><len><name>...
            hit = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
            if hit:
                name = name[hit.end():hit.end() + int(hit.group(1))]
        elif "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split(",")[-1].strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            out.append(f"{name[:40]}: {regs} registers, {spill} B spilled")
            name = None
    return out


def make_cells(dev):
    out = []
    for name, n, density, sa, sb in CELLS:
        a = pt.random(n, n, density, format="csr", seed=sa, device=dev)
        b = pt.random(n, n, density, format="csr", seed=sb, device=dev)
        out.append((name, a, b))
    return out


def phase1(dev, cells):
    """Kernel against plain version on the card; returns max |err| per
    kernel."""
    err = {"densify_onehot": 0.0, "extract_roll": 0.0}
    notes = []
    mats = [cells[0][1], cells[0][2], cells[2][1], edge_csr(dev),
            *densify_edges(dev)]
    for mat in mats:
        for with_pattern in (True, False):
            args = (mat.indptr, mat.indices, mat.data, *mat.shape)
            got = densify_onehot(*args, with_pattern=with_pattern)
            again = densify_onehot(*args, with_pattern=with_pattern)
            want = densify_onehot_plain(*args, with_pattern=with_pattern)
            if not all(same_bits(x, y) and same_bits(z, y)
                       for x, y, z in zip(got, want, again)):
                raise AssertionError(f"densify kernel != plain (or rerun) at "
                                     f"{mat.shape} nnz={mat.nnz}")
            err["densify_onehot"] = max(err["densify_onehot"],
                                        max_abs(got[0], want[0]))
    edge = mats[3]
    if edge.toarray().cpu().count_nonzero() >= edge.nnz:
        raise AssertionError("edge case lost its explicit zero")
    notes.append(f"densify bitwise and on rerun at {len(mats)} operands "
                 f"({', '.join('x'.join(map(str, x.shape)) for x in mats)}) "
                 "x 2 modes")
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
    edges = extract_edges(dev)
    for name, c, mask in edges:
        nnz = int(mask.sum())
        for cap in (nnz, nnz + 5, nnz + 40_000, max(nnz - 5, 0), 0):
            got = extract_roll(c, mask, cap)
            again = extract_roll(c, mask, cap)
            want = extract_roll_plain(c, mask, cap)
            if not all(same_bits(x, y) and same_bits(z, y)
                       for x, y, z in zip(got, want, again)):
                raise AssertionError(f"extract kernel != plain (or rerun) at "
                                     f"edge {name} cap={cap}")
    notes.append(f"extract bitwise and on rerun at {len(edges)} edges "
                 f"({', '.join(e[0] for e in edges)}) x 5 caps")
    torch.cuda.synchronize()
    print("phase 1: " + "; ".join(notes), flush=True)
    return err


def densify_edges(dev):
    """CSRs at the edges of the densify windows: rows wider than a
    4096-cell window (k = 4097, 9001), k = 4095, 1 and 3, m*k not a
    multiple of the window, explicit stored zeros and empty rows."""
    rng = np.random.default_rng(41)
    out = []
    for m, k, p in ((5, 4097, 0.05), (1, 4095, 0.3), (2, 9001, 0.1),
                    (700, 3, 0.4), (4096, 1, 0.5)):
        dense = (rng.random((m, k)) < p) * rng.standard_normal((m, k))
        dense[m // 2] = 0.0  # an empty row
        mat = sp.csr_matrix(dense.astype(np.float32))
        mat.sort_indices()
        mat.data[:2] = 0.0  # stored, so structural
        out.append(pt.CSR.from_scipy(mat, device=dev))
    return out


def extract_edges(dev):
    """(name, c, mask) edges of the one-pass extraction: rows wider than a
    4096-cell tile, many rows a tile (n = 1, 3, 15, 17), m = 1 with a
    ragged last tile, all-false and all-true masks, and a mask that starts
    off 16-byte alignment (a view into a larger buffer)."""
    rng = np.random.default_rng(31)
    out = []
    for name, m, n, p in (("3x70000", 3, 70_000, 0.7),
                          ("n=1", 20_000, 1, 0.5), ("n=3", 7_000, 3, 0.6),
                          ("n=15", 3_000, 15, 0.5), ("n=17", 3_000, 17, 0.99),
                          ("m=1", 1, 9_000, 0.5), ("all false", 333, 129, 0.0),
                          ("all true", 333, 129, 1.0)):
        mask = torch.from_numpy(rng.random((m, n)) < p).to(dev)
        c = torch.from_numpy(rng.standard_normal((m, n)).astype(
            np.float32)).to(dev) * mask
        out.append((name, c, mask))
    c, mask = out[3][1], out[3][2]
    buf = torch.zeros(mask.numel() + 3, dtype=torch.bool, device=dev)
    odd = buf[3:].view(mask.shape)
    odd.copy_(mask)
    out.append(("unaligned mask", c, odd))
    return out


class ScipyRef:
    """scipy's reference of A @ B, made once: the structure of the pattern
    product and the float64 values at its entries."""

    def __init__(self, a, b):
        a_s, b_s = a.to_scipy(), b.to_scipy()
        ones = [sp.csr_matrix((np.ones(x.nnz), x.indices, x.indptr), x.shape)
                for x in (a_s, b_s)]
        struct = (ones[0] @ ones[1]).tocsr()
        struct.sort_indices()
        self.indptr, self.indices = struct.indptr, struct.indices
        ref = (a_s.astype(np.float64) @ b_s.astype(np.float64)).tocsr()
        rows = np.repeat(np.arange(a.shape[0]), np.diff(struct.indptr))
        self.want = (np.asarray(ref[rows, struct.indices.astype(
            np.int64)]).ravel() if rows.size else np.zeros(0))

    def check(self, name, c) -> float:
        """Structure bitwise; values within RTOL*|want| + RTOL*max|want|.
        Returns max |err| / tolerance."""
        if not (np.array_equal(c.indptr.cpu().numpy(), self.indptr)
                and np.array_equal(c.indices.cpu().numpy(), self.indices)):
            raise AssertionError(f"{name}: structure differs from scipy")
        got = c.data.cpu().numpy().astype(np.float64)
        if not np.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite values")
        want = self.want
        scale = np.abs(want).max() if want.size else 0.0
        tol = RTOL * np.abs(want) + RTOL * scale
        ratio = float((np.abs(got - want) / np.maximum(tol, 1e-300)).max()
                      if want.size else 0.0)
        if ratio > 1.0:
            raise AssertionError(f"{name}: values off scipy by {ratio:.3g}x "
                                 f"the tolerance")
        return ratio


def scipy_check(name, a, b, c) -> float:
    """Structure bitwise against scipy's pattern product; values against
    scipy's float64 product.  Returns max |err| / tolerance."""
    return ScipyRef(a, b).check(name, c)


def phase2(cells):
    """The main path at every cell; returns per-kernel launch counts and
    the output nnz per cell."""
    outs = []
    _build.reset_launches()
    for name, a, b in cells:
        outs.append((pt.spgemm(a, b, alg=0), pt.spgemm(a, b, alg=0)))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # 2 runs x 2 operands densified, 2 runs x 1 extraction, per cell; the
    # SpMV/SpMM kernels are not on this path
    want = dict.fromkeys(launches, 0)
    want.update(densify_onehot=4 * len(cells), extract_roll=2 * len(cells))
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
            sg._value_matmul(ad, bd)

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
            "densify_loop_ms": loop_ms(lambda: densify_onehot(*dens_args)),
            "densify_device_ms": kernel_ms(
                lambda: densify_onehot(*dens_args), "densify_rows"),
            "densify_value_only_device_ms": kernel_ms(
                lambda: densify_onehot(*dens_args, with_pattern=False),
                "densify_rows"),
            "densify_plain_ms": median_ms(
                lambda: densify_onehot_plain(*dens_args)),
            "value_gemm_ms": median_ms(value_gemm),
            "count_gemm_ms": median_ms(lambda: torch.matmul(a_pat, b_pat)),
            "extract_ms": median_ms(lambda: extract_roll(c, mask, cap)),
            "extract_loop_ms": loop_ms(lambda: extract_roll(c, mask, cap)),
            "extract_device_ms": kernel_ms(
                lambda: extract_roll(c, mask, cap), "extract_tiles"),
            "extract_plain_ms": median_ms(
                lambda: extract_roll_plain(c, mask, cap)),
            "spgemm_peak_mb": peak_mb,
            "a_nnz": a.nnz, "c_nnz": cap,
        }
        ta_csr = torch_csr(*dens_args[:3], (m, k))
        row["torch_to_dense_ms"] = median_ms(ta_csr.to_dense)
        del ta_csr
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


# --------------------------------------------------------------------------
# SpMV / SpMM (phases 4-6)
# --------------------------------------------------------------------------

ROW_TOL = 1e-6   # |y - y64|_i <= ROW_TOL * (|A| @ |x|)_i
SPMM_K = 64      # the JAX package's SpMM width
SPMV_KERNELS = ("spmv_binned", "spmv_routed", "spmv_onehot")


def powerlaw(dev) -> pt.CSR:
    """2^20 x 2^20, 16 entries a row on average, alpha 1.5, seed 0
    (`spmm_tpu/models/matrices.py:71-88`): > 99 % empty rows and a few full
    rows of 2^20 entries."""
    return power_law_rows(1 << 20, 1 << 20, 16, alpha=1.5, seed=0,
                          device=dev)


def make_spmv_cells(dev):
    """(name, A, x or X) per SpMV and SpMM cell; x and X are N(0,1) from a
    seed.  Sources: BASELINE.md:46, BENCH_SUMMARY.md:327 and :161,
    spmm_tpu/models/matrices.py:71-88."""
    rng = np.random.default_rng(2024)
    plaw = powerlaw(dev)

    def vec(n, k=None):
        shape = (n,) if k is None else (n, k)
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    spmv_cells = [
        ("spmv 1024^2/0.1", pt.random(1024, 1024, 0.1, format="csr",
                                      seed=2008, device=dev)),
        ("spmv 16384^2/5e-3", pt.random(16384, 16384, 5e-3, format="csr",
                                        seed=2014, device=dev)),
        ("spmv powerlaw 2^20", plaw),
    ]
    spmm_cells = [
        ("spmm 10000^2/0.01 k=64", pt.random(10000, 10000, 0.01,
                                              format="csr", seed=2015,
                                              device=dev)),
        ("spmm powerlaw 2^20 k=64", plaw),
    ]
    return ([(n, a, vec(a.shape[1])) for n, a in spmv_cells],
            [(n, a, vec(a.shape[1], SPMM_K)) for n, a in spmm_cells])


def edge_csr_full_row(dev) -> pt.CSR:
    """`edge_csr` with row 20 made full (all 45 columns)."""
    m = edge_csr("cpu").to_scipy().tolil()
    m[20, :] = np.linspace(-1.0, 1.0, 45, dtype=np.float32)
    m = m.tocsr()
    m.sort_indices()
    m.data[3] = 0.0  # keep a stored zero
    return pt.CSR.from_scipy(m, device=dev)


class RowCheck:
    """scipy float64 reference of A @ x (x a vector or a matrix) and the
    rows' absolute sums |A| @ |x|, made once per (A, x)."""

    def __init__(self, a, x, transa=False):
        s = a.to_scipy().astype(np.float64)
        if transa:
            s = s.T.tocsr()
        x64 = x.double().cpu().numpy()
        self.ref = s @ x64
        self.rowabs = abs(s) @ np.abs(x64)

    def ratio(self, y, what) -> float:
        """max over cells of |y - ref| / (ROW_TOL * rowabs); fails above 1
        or on a non-finite value or a wrong shape."""
        got = y.double().cpu().numpy()
        if got.shape != self.ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{what}: shape {got.shape} (expected "
                                 f"{self.ref.shape}) or non-finite values")
        err = np.abs(got - self.ref)
        tol = ROW_TOL * self.rowabs
        bad = err > tol
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} cells off "
                                 f"scipy float64 by more than "
                                 f"{ROW_TOL}*(|A|@|x|)_i")
        scale = np.maximum(tol, 1e-300)
        return float((err / scale).max()) if err.size else 0.0


def spmv_edges(dev):
    """(name, A, x): SpMV edge cases at the kernels' boundaries: rows
    spanning many `spmv_onehot` chunks between empty leading and trailing
    rows, rows of 1, 2 and 4 `spmv_binned` pieces, an all-empty matrix, one
    row of 4999 entries (m = 1), and the 37x45 edge with a full row and a
    stored zero; x N(0,1) from seed 11."""
    rng = np.random.default_rng(11)

    def csr(lens, n):
        lens = np.asarray(lens, np.int64)
        indices = np.concatenate(
            [np.sort(rng.choice(n, int(k), replace=False)) for k in lens]
            + [np.zeros(0, np.int64)])
        indptr = np.concatenate([[0], np.cumsum(lens)])
        data = rng.standard_normal(indices.size).astype(np.float32)
        return pt.CSR.from_parts(indptr.astype(np.int32),
                                 indices.astype(np.int32), data,
                                 (lens.size, n), canonical=True, device=dev)

    span = np.zeros(60, np.int64)
    span[[5, 6, 30, 40]] = [2900, 1, 2000, 256]
    span[10:25] = rng.integers(0, 40, 15)
    hub = np.zeros(40, np.int64)
    hub[[2, 3, 9, 20]] = [3 * kb.PIECE + 7, kb.PIECE, kb.PIECE + 1,
                          kb.CLASS_BOUNDS[-1] + 1]
    hub[25:35] = rng.integers(0, 70, 10)
    mats = [("edge span chunks 60x3000", csr(span, 3000)),
            ("edge hub pieces 40x13000", csr(hub, 13000)),
            ("edge all empty 50x40", csr(np.zeros(50), 40)),
            ("edge m=1 1x5000", csr([4999], 5000)),
            ("edge 37x45", edge_csr_full_row(dev))]
    return [(name, a, torch.from_numpy(rng.standard_normal(
        a.shape[1]).astype(np.float32)).to(dev)) for name, a in mats]


def _kernel_runs(name, a, x, ch=ko.CH_DEFAULT):
    """(kernel output, its rerun, plain output) of one kernel on a."""
    m, n = a.shape
    args = (a.indptr, a.indices, a.data)
    if name == "spmv_binned":
        p = kb.spmv_binned_plan(*args, m, n)
        run, plain = (lambda: kb.spmv_binned(x, p),
                      lambda: kb.spmv_binned_plain(x, p))
    elif name == "spmv_onehot":
        p = ko.spmv_onehot_plan(a.indptr, m, n, ch=ch)
        run = lambda: ko.spmv_onehot(*args, x, m, n, p)  # noqa: E731
        plain = lambda: ko.spmv_onehot_plain(*args, x, m, n, p)  # noqa: E731
    elif name == "spmv_routed":
        p = kr.spmv_routed_plan(*args, m, n)
        run, plain = (lambda: kr.spmv_routed(x, p),
                      lambda: kr.spmv_routed_plain(x, p))
    else:  # spmm_routed, over the serving plan and over the per-call one
        p = kr.spmv_routed_plan(*args, m, n, sell=(name == "spmm_routed"))
        run, plain = (lambda: kr.spmm_routed(x, p),
                      lambda: kr.spmm_routed_plain(x, p))
    return run(), run(), plain()


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary (a column slice made contiguous at an odd offset)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def spmm_edge_checks(dev, edges, err) -> dict:
    """`spmm_routed` at the SpMV edges and a full row of 9000 entries, at
    k = 1, 33, 45, 64 and 128, on an X 16-byte aligned and one that is not
    (the kernel's one-column lanes), over both kinds of plan at the default
    cut and at cut 8 with chunks of 16 (rows closed by up to 563 chunks):
    against its plain version and scipy's float64 product, bitwise on
    rerun, every counter reset; returns the worst ratio per edge."""
    rng = np.random.default_rng(13)
    full = pt.CSR.from_parts(
        np.array([0, 0, 9000, 9000], np.int32), np.arange(9000,
                                                          dtype=np.int32),
        rng.standard_normal(9000).astype(np.float32), (3, 9000),
        canonical=True, device=dev)
    worst = {}
    for name, a, _ in edges + [("edge full row 3x9000", full, None)]:
        m, n = a.shape
        args = (a.indptr, a.indices, a.data)
        for k in (1, 33, 45, 64, 128):
            x = torch.from_numpy(rng.standard_normal((n, k)).astype(
                np.float32)).to(dev)
            check = RowCheck(a, x)
            for xx in (x, misaligned(x)):
                for kw in ({}, {"cut": 8, "ch": 16}):
                    for sell in (True, False):
                        p = kr.spmv_routed_plan(*args, m, n, sell=sell, **kw)
                        got = kr.spmm_routed(xx, p)
                        again = kr.spmm_routed(xx, p)
                        plain = kr.spmm_routed_plain(xx, p)
                        torch.cuda.synchronize()
                        what = (f"spmm_routed @ {name} k={k} "
                                f"{xx.data_ptr() % 16} {kw} sell={sell}")
                        if not same_bits(got, again) or p.counters.any():
                            raise AssertionError(f"{what}: rerun not bitwise "
                                                 "or a counter left set")
                        r = max(check.ratio(got, what),
                                check.ratio(plain, f"{what} (plain)"))
                        worst[f"spmm_routed @ {name} (k, X, plans)"] = max(
                            worst.get(f"spmm_routed @ {name} (k, X, plans)",
                                      0.0), r)
                        err["spmm_routed"] = max(err["spmm_routed"],
                                                 max_abs(got, plain))
    return worst


def axis1_segments(a):
    """The in-order segment sum behind `a.sum(axis=1)` of a CSR: its data
    and its rows as (starts, lengths)."""
    return a.data, a.indptr[:-1], a.indptr[1:] - a.indptr[:-1]


def phase4(dev, spmv_cells, spmm_cells):
    """Each SpMV/SpMM kernel against its plain version and scipy on the
    card, `spmv_onehot` also at every chunk size on the edges, and
    `segment_sum` bitwise against its plain version on the CPU; returns
    (max |kernel - plain| per kernel, worst ratio per kernel and cell, the
    reference checks)."""
    edges = spmv_edges(dev)
    rng = np.random.default_rng(7)
    edge = edges[-1][1]
    eX = torch.from_numpy(rng.standard_normal((45, 33)).astype(
        np.float32)).to(dev)
    jobs = [(k, name, a, x, ko.CH_DEFAULT) for name, a, x in
            spmv_cells + edges for k in SPMV_KERNELS]
    jobs += [("spmv_onehot", name, a, x, ch) for name, a, x in edges
             for ch in ko.CH_CHOICES if ch != ko.CH_DEFAULT]
    jobs += [(k, name, a, x, None) for name, a, x in
             spmm_cells + [("edge 37x45 k=33", edge, eX)]
             for k in ("spmm_routed", "spmm_routed_percall")]
    err = {k: 0.0 for k in (*SPMV_KERNELS, "spmm_routed")}
    ratios = {}
    checks = {}
    for kernel, name, a, x, ch in jobs:
        key = (name, id(x))
        if key not in checks:
            checks[key] = RowCheck(a, x)
        got, again, plain = _kernel_runs(kernel, a, x, ch)
        torch.cuda.synchronize()
        what = f"{kernel} at {name}" + ("" if ch in (None, ko.CH_DEFAULT)
                                        else f" ch={ch}")
        if not same_bits(got, again):
            raise AssertionError(f"{what}: rerun not bitwise")
        r_k = checks[key].ratio(got, what)
        r_p = checks[key].ratio(plain, f"{what} (plain)")
        base = "spmm_routed" if kernel.startswith("spmm") else kernel
        err[base] = max(err[base], max_abs(got, plain))
        ratios[what.replace(" at ", " @ ")] = [r_k, r_p]
        del got, again, plain
    ratios.update(spmm_edge_checks(dev, edges, err))
    # the binned plan kernels: bitwise their plain version on the card
    for name, a, _ in spmv_cells + edges:
        m, n = a.shape
        p = kb.spmv_binned_plan(a.indptr, a.indices, a.data, m, n)
        plain = kb.spmv_binned_plan_plain(a.indptr, m, p.piece_row.numel())
        total = int(plain[2][-1])
        if not all(same_bits(x, y) for x, y in zip(
                (p.rows, p.class_off, p.piece_end, p.piece_row[:total]),
                plain[:3] + (plain[3][:total],))):
            raise AssertionError(f"spmv_binned_plan at {name}: the kernels' "
                                 "plan differs from the plain version's")
    err["spmv_binned_plan"] = 0.0
    # the in-order segment sum: bitwise its plain version on the CPU (on a
    # card the plain version adds with atomics, in no fixed order), one
    # column and three
    plaw = spmv_cells[-1][1]
    vals, starts, lengths = axis1_segments(plaw)
    cases = [(vals, starts, lengths),
             (torch.stack([vals, -vals, 2 * vals], 1), starts, lengths)]
    err["segment_sum"] = 0.0
    for args in cases:
        got = ks.segment_sum_inorder(*args)
        want = ks.segment_sum_inorder_plain(*(t.cpu() for t in args))
        if not same_bits(got.cpu(), want):
            raise AssertionError("segment_sum kernel != its plain version on "
                                 f"the CPU at {tuple(args[0].shape)}")
        err["segment_sum"] = max(err["segment_sum"], max_abs(got.cpu(), want))
    print("phase 4: worst |y - y64| / (1e-6 |A||x|)_i, [kernel, plain]: "
          + json.dumps(ratios) + "; spmv_binned_plan bitwise its plain "
          "version at every SpMV cell and edge; segment_sum bitwise the "
          f"CPU's at {[tuple(c[0].shape) for c in cases]}", flush=True)
    return err, ratios, checks, edges


def phase5(spmv_cells, spmm_cells, edges, checks):
    """The entry points at every cell and edge, against scipy, bitwise on
    rerun, and with each kernel's launch count as expected; the axis sums
    and `diagonal()` of the SpMV matrices bitwise the CPU's; returns the
    counts."""
    runs = []
    for name, a, x in spmv_cells + edges:
        routed = pt.spmv_plan(a)
        onehot = ("onehot", ko.spmv_onehot_plan(a.indptr, *a.shape))
        m, n = a.shape
        xt = x.repeat(-(-m // n))[:m].contiguous()  # op(A) = A^T takes m
        runs += [
            (f"spmv(a, x) @ {name}", lambda a=a, x=x: pt.spmv(a, x),
             (name, id(x))),
            (f"spmv(plan=onehot) @ {name}",
             lambda a=a, x=x, p=onehot: pt.spmv(a, x, plan=p), (name, id(x))),
            (f"spmv(transa) @ {name}",
             lambda a=a, x=xt: pt.spmv(a, x, transa=True), (name, "T")),
            (f"a @ x @ {name}", lambda a=a, x=x: a @ x, (name, id(x))),
        ]
        if routed is not None:  # None for an empty matrix, as in JAX
            runs.append((f"spmv(plan=routed) @ {name}",
                         lambda a=a, x=x, p=routed: pt.spmv(a, x, plan=p),
                         (name, id(x))))
        checks[(name, "T")] = RowCheck(a, xt, transa=True)
    nrouted = sum(what.startswith("spmv(plan=routed)") for what, _, _ in runs)
    for name, a, X in spmm_cells:
        routed = pt.spmv_plan(a)
        runs += [
            (f"spmm(a, X) @ {name}", lambda a=a, X=X: pt.spmm(a, X),
             (name, id(X))),
            (f"spmm(plan=routed) @ {name}",
             lambda a=a, X=X, p=routed: pt.spmm(a, X, plan=p), (name, id(X))),
            (f"a @ X @ {name}", lambda a=a, X=X: a @ X, (name, id(X))),
        ]
    # the in-order sums: sum(axis=1) of the power-law matrix, diagonal() of
    # the uniform ones
    sums = [(f"sum(axis=1) @ {spmv_cells[-1][0]}", spmv_cells[-1][1],
             lambda a: a.sum(axis=1))]
    sums += [(f"diagonal() @ {name}", a, lambda a: a.diagonal())
             for name, a, _ in spmv_cells[:2]]
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [(what, fn(), fn(), key) for what, fn, key in runs]
    outs_sum = [(what, a, fn(a), fn(a)) for what, a, fn in sums]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    nspmv, nspmm = len(spmv_cells) + len(edges), len(spmm_cells)
    # a @ X goes dense (densify + one GEMM) where A's density reaches the
    # break-even curve, else to spmm_routed
    dense = sum(a.density >= pt.break_even_density(*a.shape, X.shape[1])
                for _, a, X in spmm_cells)
    want = dict.fromkeys(launches, 0)
    want.update({"densify_onehot": 2 * dense,
                 "spmv_binned": 2 * 3 * nspmv, "spmv_routed": 2 * nrouted,
                 "spmv_binned_plan": 2 * 3 * nspmv,
                 "spmv_onehot": 2 * nspmv,
                 "spmm_routed": 2 * (2 * nspmm + nspmm - dense),
                 "segment_sum": 2 * len(sums)})
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    notes = {}
    for what, y1, y2, key in outs:
        if not same_bits(y1, y2):
            raise AssertionError(f"{what}: rerun not bitwise")
        notes[what] = checks[key].ratio(y1, what)
    for what, a, y1, y2 in outs_sum:
        cpu = a.to("cpu")
        want_y = cpu.sum(axis=1) if what.startswith("sum") else cpu.diagonal()
        if not (same_bits(y1, y2) and same_bits(y1.cpu(), want_y)):
            raise AssertionError(f"{what}: not bitwise on rerun and the CPU's")
        if what.startswith("sum"):
            # JAX's in-order sum (bitwise the CPU's, above) against scipy's
            # float64 sum, within the bound of adding len terms in order,
            # gamma_(len-1) sum_j |a_ij| with gamma_k = k u / (1 - k u) and
            # u = 2^-24: a row of 2^20 terms added in order does not keep
            # 1e-6 of its absolute sum
            s64 = a.to_scipy().astype(np.float64)
            ref = np.asarray(s64.sum(axis=1)).ravel()
            ku = np.maximum(np.diff(s64.indptr) - 1, 0) * 2.0**-24
            tol = ku / (1 - ku) * np.asarray(abs(s64).sum(axis=1)).ravel()
            err = np.abs(y1.cpu().double().numpy() - ref)
            if (err > tol).any():
                raise AssertionError(f"{what}: {int((err > tol).sum())} rows "
                                     "off scipy's float64 sum by more than "
                                     "the in-order bound")
            notes[what] = float((err / np.maximum(tol, 1e-300)).max())
        else:
            ref = a.to_scipy().diagonal().astype(np.float32)
            if not np.array_equal(y1.cpu().numpy(), ref):
                raise AssertionError(f"{what}: differs from scipy's")
            notes[what] = 0.0
    print(f"phase 5: launches {launches}; worst ratio per entry point "
          + json.dumps(notes), flush=True)
    return launches


def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock time of `fn` ending in a device sync."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def loop_ms(fn, calls: int = 200) -> float:
    """Device time per call: CUDA events around `calls` back-to-back calls
    (after a warm-up), over the count.  Where the host enqueues slower than
    the device runs, this is the host's rate."""
    for _ in range(WARMUP):
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


def kernel_busy_ms(fn, calls: int = 50):
    """Device busy time per call of `fn` from a profiler trace (None where
    the trace holds no device events)."""
    return device_profile(fn, calls)[0]


def _torch_csr(a):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # beta notices
        return torch.sparse_csr_tensor(a.indptr.long(), a.indices.long(),
                                       a.data, a.shape)


def spmv_bound_ms(nnz: int, m: int, n: int):
    """The least time of y = A @ x: (index, value) per entry, indptr, x and
    y once each, over the HBM rate; 2 flops an entry."""
    return bound(8 * nnz + 4 * (m + 1) + 4 * n + 4 * m, 2 * nnz)


def phase6(spmv_cells, spmm_cells, smi):
    """CUDA-event timings per cell; returns the table rows."""
    rows = []
    for name, a, x in spmv_cells:
        m, n = a.shape
        args = (a.indptr, a.indices, a.data)
        routed = kr.spmv_routed_plan(*args, m, n)
        binned = kb.spmv_binned_plan(*args, m, n)
        onehot = ko.spmv_onehot_plan(a.indptr, m, n)
        ta = _torch_csr(a)
        call_b = lambda: kb.spmv_binned(x, binned)  # noqa: E731
        call_o = lambda: ko.spmv_onehot(*args, x, m, n, onehot)  # noqa: E731
        call_r = lambda: kr.spmv_routed(x, routed)  # noqa: E731
        call_mv = lambda: torch.mv(ta, x)  # noqa: E731
        row = {
            "cell": name, "nnz": a.nnz, "m": m, "n": n,
            "bound_ms": spmv_bound_ms(a.nnz, m, n)[0],
            "routed_slack": routed.slack,
            "plan_routed_host_ms": host_ms(
                lambda: kr.spmv_routed_plan(*args, m, n)),
            "plan_binned_host_ms": host_ms(
                lambda: kb.spmv_binned_plan(*args, m, n)),
            "spmv_binned_plan_ms": median_ms(
                lambda: kb.spmv_binned_plan(*args, m, n)),
            "spmv_binned_plan_plain_ms": median_ms(
                lambda: kb.spmv_binned_plan_plain(
                    a.indptr, m, binned.piece_row.numel())),
            "spmv_binned_plan_busy_ms": kernel_busy_ms(
                lambda: kb.spmv_binned_plan(*args, m, n)),
            "plan_onehot_host_ms": host_ms(
                lambda: ko.spmv_onehot_plan(a.indptr, m, n)),
            # in turns: library, kernels, kernels, library
            "torch_csr_mv_ms": median_ms(call_mv),
            "spmv_binned_ms": median_ms(call_b),
            "spmv_onehot_ms": median_ms(call_o),
            "spmv_routed_ms": median_ms(call_r),
            "spmv_binned_ms_2": median_ms(call_b),
            "spmv_onehot_ms_2": median_ms(call_o),
            "spmv_routed_ms_2": median_ms(call_r),
            "torch_csr_mv_ms_2": median_ms(call_mv),
            "spmv_binned_loop_ms": loop_ms(call_b),
            "spmv_onehot_loop_ms": loop_ms(call_o),
            "spmv_routed_loop_ms": loop_ms(call_r),
            "torch_csr_mv_loop_ms": loop_ms(call_mv),
            "spmv_binned_busy_ms": kernel_busy_ms(call_b),
            "spmv_onehot_busy_ms": kernel_busy_ms(call_o),
            "spmv_routed_busy_ms": kernel_busy_ms(call_r),
            "torch_csr_mv_busy_ms": kernel_busy_ms(call_mv),
            "spmv_binned_plain_ms": median_ms(
                lambda: kb.spmv_binned_plain(x, binned)),
            "spmv_routed_plain_ms": median_ms(
                lambda: kr.spmv_routed_plain(x, routed)),
            "spmv_onehot_plain_ms": median_ms(
                lambda: ko.spmv_onehot_plain(*args, x, m, n, onehot)),
            "spmv_call_ms": median_ms(lambda: pt.spmv(a, x)),
            "spmv_call_loop_ms": loop_ms(lambda: pt.spmv(a, x)),
            "spmv_tag_routed_ms": median_ms(
                lambda: pt.spmv(a, x, plan=("routed", routed))),
            "spmv_tag_binned_ms": median_ms(
                lambda: pt.spmv(a, x, plan=("binned", binned))),
            "spmv_tag_onehot_ms": median_ms(
                lambda: pt.spmv(a, x, plan=("onehot", onehot))),
            "spmv_transa_ms": median_ms(lambda: pt.spmv(a, x, transa=True)),
        }
        # the chunk size of spmv_onehot, device time per call at each
        for ch in ko.CH_CHOICES[2:]:
            p = ko.spmv_onehot_plan(a.indptr, m, n, ch=ch)
            row[f"spmv_onehot_ch{ch}_busy_ms"] = kernel_busy_ms(
                lambda p=p: ko.spmv_onehot(*args, x, m, n, p))
            row[f"spmv_onehot_ch{ch}_loop_ms"] = loop_ms(
                lambda p=p: ko.spmv_onehot(*args, x, m, n, p))
        for tag in ("call", "tag_routed", "tag_binned", "tag_onehot"):
            row[f"spmv_{tag}_gnnz_s"] = a.nnz / row[f"spmv_{tag}_ms"] / 1e6
        row["spmv_routed_device_top_ms"] = device_profile(call_r)[1]
        busy, top = device_profile(
            lambda: pt.spmv(a, x, plan=("routed", routed)))
        row["spmv_tag_routed_device_busy_ms"] = busy
        row["spmv_tag_routed_idle_share"] = (
            None if busy is None else 1.0 - busy / row["spmv_tag_routed_ms"])
        busy, top = device_profile(lambda: pt.spmv(a, x))
        row["spmv_call_device_busy_ms"] = busy
        row["spmv_call_idle_share"] = (
            None if busy is None else 1.0 - busy / row["spmv_call_ms"])
        row["spmv_call_device_top_ms"] = top
        # the in-order sums on the card
        row["diagonal_ms"] = median_ms(a.diagonal, runs=5, warmup=1)
        row["sum_axis1_ms"] = median_ms(lambda: a.sum(axis=1), runs=5,
                                        warmup=1)
        seg = axis1_segments(a)
        row["segment_sum_ms"] = median_ms(
            lambda: ks.segment_sum_inorder(*seg), runs=5, warmup=1)
        row["segment_sum_plain_ms"] = median_ms(
            lambda: ks.segment_sum_inorder_plain(*seg), runs=5, warmup=1)
        row["segment_sum_library_ms"] = median_ms(
            lambda: torch.segment_reduce(a.data, "sum", lengths=seg[2]),
            runs=5, warmup=1)
        rows.append(row)
        del ta
        print(f"phase 6 [{smi}]: " + json.dumps(row), flush=True)
    for name, a, X in spmm_cells:
        m, n = a.shape
        k = X.shape[1]
        args = (a.indptr, a.indices, a.data)
        routed = kr.spmv_routed_plan(*args, m, n)
        percall = kr.spmv_routed_plan(*args, m, n, sell=False)
        ta = _torch_csr(a)
        row = {
            "cell": name, "nnz": a.nnz, "m": m, "n": n, "k": k,
            "plan_routed_host_ms": host_ms(
                lambda: kr.spmv_routed_plan(*args, m, n)),
            "plan_percall_host_ms": host_ms(
                lambda: kr.spmv_routed_plan(*args, m, n, sell=False)),
            "spmm_routed_ms": median_ms(lambda: kr.spmm_routed(X, routed)),
            "spmm_routed_percall_plan_ms": median_ms(
                lambda: kr.spmm_routed(X, percall)),
            "spmm_routed_plain_ms": median_ms(
                lambda: kr.spmm_routed_plain(X, routed)),
            "spmm_call_ms": median_ms(lambda: pt.spmm(a, X)),
            "spmm_tag_routed_ms": median_ms(
                lambda: pt.spmm(a, X, plan=("routed", routed))),
            "torch_csr_mm_ms": median_ms(lambda: ta @ X),
            "spmm_routed_loop_ms": loop_ms(lambda: kr.spmm_routed(X, routed)),
            "spmm_routed_device_ms": kernel_ms(
                lambda: kr.spmm_routed(X, routed), "spmm_routed"),
            "spmm_routed_percall_plan_device_ms": kernel_ms(
                lambda: kr.spmm_routed(X, percall), "spmm_routed"),
            "torch_csr_mm_busy_ms": kernel_busy_ms(lambda: ta @ X),
            # the CSR, X and Y once; what the gathers of X move
            "bound_ms": bound(8 * a.nnz + 4 * (m + 1) + 4 * k * (n + m),
                              2 * a.nnz * k)[0],
            "gathered_bytes": 4 * k * a.nnz,
            "long_rows": routed.long_rows.numel(),
            "chunks": routed.chunk_start.numel(),
        }
        for key in ("spmm_routed", "spmm_call", "spmm_tag_routed"):
            row[f"{key}_gmac_s"] = a.nnz * k / row[f"{key}_ms"] / 1e6
        busy, top = device_profile(lambda: pt.spmm(a, X))
        row["spmm_call_device_busy_ms"] = busy
        row["spmm_call_idle_share"] = (
            None if busy is None else 1.0 - busy / row["spmm_call_ms"])
        row["spmm_call_device_top_ms"] = top
        rows.append(row)
        del ta
        print(f"phase 6 [{smi}]: " + json.dumps(row), flush=True)
    return rows


# --------------------------------------------------------------------------
# serving and ESC (phases 7-9)
# --------------------------------------------------------------------------

# (name, n, density, seed of A, seed of B): BASELINE.md:20 and :59 (serving),
# :21-22 and :24-25 (ESC)
SERVE_CELLS = [CELLS[0], CELLS[2]]
ESC_CELLS = [CELLS[0], CELLS[1]]
ESC_RUNS = [("alg2", 2, 0.2), ("alg3 cf=0.2", 3, 0.2),
            ("alg3 cf=0.05", 3, 0.05)]
BATCH_K = 8


def ulp_gap(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest distance in units of the last place between two float32
    tensors of one shape (0 when bitwise equal)."""
    if x.numel() == 0:
        return 0
    d = x.view(torch.int32).long() - y.view(torch.int32).long()
    return int(d.abs().max())


def edge_pairs(dev):
    """(name, A, B): the edge CSR (explicit zero, empty rows) times a 45x29
    matrix with empty rows and columns, and a pair whose product is empty
    (A stores column 0 only, B row 5 only)."""
    rng = np.random.default_rng(8)
    dense = (rng.random((45, 29)) < 0.25) * rng.standard_normal((45, 29))
    dense[[0, 3, 44]] = 0.0
    dense[:, [1, 2, 28]] = 0.0
    b = pt.CSR.from_scipy(sp.csr_matrix(dense.astype(np.float32)), device=dev)
    a0 = pt.CSR.from_parts(np.arange(9, dtype=np.int32), np.zeros(8, np.int32),
                           np.ones(8, np.float32), (8, 9), canonical=True,
                           device=dev)
    b0 = pt.CSR.from_parts(np.array([0] * 6 + [1] * 4, np.int32),
                           np.array([2], np.int32), np.ones(1, np.float32),
                           (9, 7), canonical=True, device=dev)
    return [("edge 37x45x29", edge_csr(dev), b),
            ("empty output 8x9x7", a0, b0)]


def expand_edges():
    """(name, indptr, indices, data, m, k) host CSRs at the edges of the
    windowed expansion: rows wider than a 4096-cell window, m = 1 with a
    ragged last window, many rows a window (k = 1, 3, 15, 17), and a
    structure out of order (the plan sorts it)."""
    rng = np.random.default_rng(32)
    out = []
    for name, m, k, p in (("3x70000", 3, 70_000, 0.01),
                          ("m=1 4099", 1, 4099, 0.3), ("k=1", 9_000, 1, 0.5),
                          ("k=3", 3_000, 3, 0.4), ("k=15", 700, 15, 0.2),
                          ("k=17", 700, 17, 0.9)):
        s = sp.random(m, k, p, format="csr", dtype=np.float32,
                      random_state=rng)
        s.data[::7] = -0.0  # the sign of zero travels
        out.append((name, s.indptr.astype(np.int32),
                    s.indices.astype(np.int32), s.data, m, k))
    s = sp.random(200, 333, 0.05, format="csr", dtype=np.float32,
                  random_state=rng)
    ip, ix, d = s.indptr.astype(np.int32), s.indices.astype(np.int32), s.data
    for r in range(200):  # each row's entries reversed
        ix[ip[r]:ip[r + 1]] = ix[ip[r]:ip[r + 1]][::-1].copy()
        d[ip[r]:ip[r + 1]] = d[ip[r]:ip[r + 1]][::-1].copy()
    out.append(("unsorted 200x333", ip, ix, d, 200, 333))
    return out


def fresh(a, rng):
    """A with the same structure and new N(0,1) values."""
    vals = torch.from_numpy(rng.standard_normal(a.nnz).astype(np.float32))
    return pt.CSR.from_parts(a.indptr, a.indices, vals.to(a.device), a.shape,
                             canonical=True)


def phase7(dev):
    """Serving plans: routed kernels against their plain versions, plan
    calls against scipy and alg1, launch counts; returns (launches, max
    |kernel - plain| per kernel, the plans by cell)."""
    from spmm_tpu_torch.ops.kernels import route

    err = {"expand_routed": 0.0, "compress_routed": 0.0}
    pairs = [(name, pt.random(n, n, d, format="csr", seed=sa, device=dev),
              pt.random(n, n, d, format="csr", seed=sb, device=dev))
             for name, n, d, sa, sb in SERVE_CELLS] + edge_pairs(dev)
    t0 = time.perf_counter()
    plans = [pt.spgemm_plan(a, b) for _, a, b in pairs]
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(2025)
    # kernels against plain versions, bitwise
    for (name, a, b), plan in zip(pairs, plans):
        for vals, p in ((a.data, plan._pa), (b.data, plan._pb)):
            for emit in (True, False):
                got = route.densify_routed(vals, p, emit)
                want = route.densify_routed_plain(vals, p, emit)
                got, want = ((got, want) if emit else ((got,), (want,)))
                if not all(same_bits(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"expand_routed != plain at {name}")
                err["expand_routed"] = max(err["expand_routed"],
                                           max_abs(got[0], want[0]))
        if plan._pc is None:
            continue
        c = plan._product(a.data, b.data)
        prev = torch.from_numpy(rng.standard_normal(plan.nnz).astype(
            np.float32)).to(dev)
        # the plan's int32 positions, and int64 ones (a plan past 2^31
        # cells); the accumulate also written in place into prev
        for pc in (plan._pc, plan._pc._replace(pos=plan._pc.pos.long())):
            for kw in ({}, {"alpha": -1.7}, {"alpha": 0.5, "c_prev": prev,
                                             "beta": -2.0}):
                got = route.extract_routed(c, pc, **kw)
                want = route.extract_routed_plain(c, pc, **kw)
                if not same_bits(got, want):
                    raise AssertionError(
                        f"compress_routed != plain at {name} {pc.pos.dtype} "
                        f"{sorted(kw)}")
                err["compress_routed"] = max(err["compress_routed"],
                                             max_abs(got, want))
            buf = prev.clone()  # the last form again, in place
            got = route.extract_routed(c, pc, 0.5, c_prev=buf, beta=-2.0,
                                       out=buf)
            if not (got is buf and same_bits(got, want)):
                raise AssertionError(f"compress_routed in place != plain at "
                                     f"{name} {pc.pos.dtype}")
        del c
    edges = expand_edges()
    for name, indptr, indices, data, m, k in edges:
        p = route.expand_route_plan(indptr, indices, m, k)  # on the card
        vals = torch.from_numpy(data).to(dev)
        ws = torch.full((m, k), float("nan"), device=dev)
        odd = torch.full((m * k + 1,), 3.0, device=dev)[1:].view(m, k)
        for emit in (True, False):
            want = route.densify_routed_plain(vals, p, emit)
            want = want if emit else (want,)
            for out in (None, ws, odd):
                got = route.densify_routed(vals, p, emit, out=out)
                got = got if emit else (got,)
                if not all(same_bits(x, y) for x, y in zip(got, want)):
                    raise AssertionError(
                        f"expand_routed != plain at edge {name} (pattern "
                        f"{emit}, out given: {out is not None})")
    torch.cuda.synchronize()
    # the main path: plan calls, fresh values, accumulate, batch
    _build.reset_launches()
    outs = []
    for (name, a, b), plan in zip(pairs, plans):
        a2, b2 = fresh(a, rng), fresh(b, rng)
        c1 = plan(a.data, b.data)
        c2 = plan(a.data, b.data)
        cf = plan(a2.data, b2.data)
        acc = torch.zeros(plan.nnz, device=dev)
        plan.values_accumulate(acc, a.data, b.data)
        plan.values_accumulate(acc, a.data, b.data, alpha=-1.0, beta=1.0)
        av = torch.stack([a.data * (i + 1) for i in range(BATCH_K)])
        bv = torch.stack([b.data] * BATCH_K)
        batch = plan.values_batch(av, bv, alpha=0.5)
        outs.append((c1, c2, cf, a2, b2, acc, av, bv, batch))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # 3 calls, 2 accumulates and K batch rows per pair; a plan with an
    # empty output computes nothing
    calls = (5 + BATCH_K) * sum(p.nnz > 0 for p in plans)
    want = dict.fromkeys(launches, 0)
    want.update(expand_routed=2 * calls, compress_routed=calls)
    if launches != want:
        raise AssertionError(f"serving launch counts {launches}, expected "
                             f"{want}")
    notes = []
    for (name, a, b), plan, out in zip(pairs, plans, outs):
        c1, c2, cf, a2, b2, acc, av, bv, batch = out
        if not (same_bits(c1.data, c2.data) and c1.indptr is plan.indptr):
            raise AssertionError(f"{name}: plan rerun not bitwise")
        ratio = scipy_check(f"plan {name}", a, b, c1)
        ratio_f = scipy_check(f"plan fresh {name}", a2, b2, cf)
        if acc.any():
            raise AssertionError(f"{name}: C + A@B - A@B is not 0")
        for i in range(BATCH_K):
            if not same_bits(batch[i], plan.values(av[i], bv[i], 0.5)):
                raise AssertionError(f"{name}: values_batch row {i} != call")
        alg1 = pt.spgemm(a, b, alg=1)
        gap = ulp_gap(c1.data, alg1.data) if alg1.nnz == c1.nnz else None
        notes.append(f"{name} nnz={plan.nnz} err/tol={ratio:.3g} "
                     f"fresh={ratio_f:.3g} rerun, batch, accumulate bitwise; "
                     f"== spgemm(alg=1): {gap == 0} (max ulp {gap})")
        del out, alg1
    notes.append(f"expand_routed bitwise at {len(edges)} edges "
                 f"({', '.join(e[0] for e in edges)}), fresh, into a "
                 "workspace and into one off 16-byte alignment")
    print(f"phase 7: plans built in {build_s:.2f} s; launches {launches}; "
          + "; ".join(notes), flush=True)
    return launches, err, dict(zip([p[0] for p in pairs],
                                   zip(pairs, plans)))


def phase8(dev):
    """ESC alg2/alg3 against scipy, each other, reruns and (at the small
    cell) the CPU; returns the operands by cell."""
    notes = []
    cells = []
    for name, n, d, sa, sb in ESC_CELLS:
        a = pt.random(n, n, d, format="csr", seed=sa, device=dev)
        b = pt.random(n, n, d, format="csr", seed=sb, device=dev)
        P, _ = pt.spgemm_nnz_estimate(a, b)
        ref = None
        for what, alg, cf in ESC_RUNS:
            c = pt.spgemm(a, b, alg=alg, chunk_fraction=cf, impl="esc")
            again = pt.spgemm(a, b, alg=alg, chunk_fraction=cf, impl="esc")
            torch.cuda.synchronize()
            if not all(same_bits(x, y) for x, y in
                       ((c.indptr, again.indptr), (c.indices, again.indices),
                        (c.data, again.data))):
                raise AssertionError(f"ESC {what} at {name}: rerun differs")
            del again
            if ref is None:
                ratio = scipy_check(f"ESC {what} {name}", a, b, c)
                ref = c
            elif not all(same_bits(x, y) for x, y in
                         ((c.indptr, ref.indptr), (c.indices, ref.indices),
                          (c.data, ref.data))):
                raise AssertionError(f"ESC {what} at {name} != alg2")
            if name == ESC_CELLS[0][0] and what != ESC_RUNS[1][0]:
                cpu = pt.spgemm(a.to("cpu"), b.to("cpu"), alg=alg,
                                chunk_fraction=cf, impl="esc")
                if not (same_bits(cpu.indices, c.indices.cpu())
                        and same_bits(cpu.data, c.data.cpu())):
                    raise AssertionError(f"ESC {what} at {name}: card != CPU")
                what += " == CPU"
            notes.append(f"{name} {what} nnz={c.nnz}")
            del c
        notes.append(f"{name} P={P} err/tol={ratio:.3g}, alg3 == alg2 and "
                     "reruns bitwise")
        del ref
        cells.append((name, a, b))
        torch.cuda.empty_cache()
    print("phase 8: " + "; ".join(notes), flush=True)
    return cells


def host_syncs(fn) -> int:
    """Synchronizing CUDA calls made by one call of `fn`: torch's sync
    debug mode warns once for each (matched by the warning's own words, not
    its one-time notice that the mode is a prototype)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def peak_mb(fn) -> float:
    """Increase of the allocator's peak over what is allocated, one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def compress_bound(row):
    """The least time of the serving gather out[i] = alpha * c[pos[i]]:
    the positions (4 or 8 bytes an entry) and the output once, and c
    counted in the 32-byte sectors its entries touch (8 entries a sector
    where the output structure is dense, one where it is sparse)."""
    return bound((row["pos_bytes"] + 4) * row["nnz"] + 32 * row["c_sectors"],
                 row["nnz"])


def phase9(serving, esc_cells, smi):
    """CUDA-event medians of serving and ESC; returns the rows."""
    from spmm_tpu_torch.ops.kernels import route

    rows = []
    for name, _, _, _, _ in SERVE_CELLS:
        (_, a, b), plan = serving[name]
        cap = plan.nnz
        c = plan._product(a.data, b.data)
        av = torch.stack([a.data] * BATCH_K)
        bv = torch.stack([b.data] * BATCH_K)
        pc = plan._pc
        pos64 = pc.pos.long()  # torch.take's index type, made once
        call_c = lambda: route.extract_routed(c, pc)  # noqa: E731
        call_take = lambda: torch.take(c, pos64)  # noqa: E731
        row = {
            "cell": f"serving {name}", "nnz": cap,
            "pos_bytes": pc.pos.element_size(),
            # the 32-byte sectors of c the gather touches
            "c_sectors": int(torch.unique(pos64 // 8).numel()),
            "plan_build_host_ms": host_ms(lambda: pt.spgemm_plan(a, b)),
            "plan_call_ms": median_ms(lambda: plan(a.data, b.data)),
            "values_ms": median_ms(lambda: plan.values(a.data, b.data)),
            "values_batch_per_multiply_ms": median_ms(
                lambda: plan.values_batch(av, bv)) / BATCH_K,
            "expand_routed_ms": median_ms(lambda: route.densify_routed(
                a.data, plan._pa, emit_pattern=False)),
            "expand_routed_loop_ms": loop_ms(lambda: route.densify_routed(
                a.data, plan._pa, emit_pattern=False)),
            "expand_routed_device_ms": kernel_ms(
                lambda: route.densify_routed(a.data, plan._pa,
                                             emit_pattern=False),
                "expand_routed"),
            "expand_routed_plain_ms": median_ms(
                lambda: route.densify_routed_plain(a.data, plan._pa,
                                                   emit_pattern=False)),
            # in turns: library, kernel, kernel, library
            "compress_library_ms": median_ms(call_take),
            "compress_routed_ms": median_ms(call_c),
            "compress_routed_ms_2": median_ms(call_c),
            "compress_library_ms_2": median_ms(call_take),
            "compress_routed_loop_ms": loop_ms(call_c),
            "compress_library_loop_ms": loop_ms(call_take),
            "compress_routed_busy_ms": kernel_busy_ms(call_c),
            "compress_library_busy_ms": kernel_busy_ms(call_take),
            "compress_routed_plain_ms": median_ms(
                lambda: route.extract_routed_plain(c, pc)),
            "spgemm_alg1_ms": median_ms(lambda: pt.spgemm(a, b, alg=1)),
            "spgemm_fixed_ms": median_ms(
                lambda: pt.spgemm_fixed(a, b, cap=cap)),
            "a_nnz": a.nnz, "a_shape": list(a.shape),
        }
        row["compress_bound_ms"] = compress_bound(row)[0]
        ta_csr = torch_csr(a.indptr, a.indices, a.data, a.shape)
        row["expand_library_ms"] = median_ms(ta_csr.to_dense)
        del ta_csr, pos64
        row["plan_call_host_syncs"] = host_syncs(lambda: plan(a.data, b.data))
        busy, top = device_profile(lambda: plan(a.data, b.data))
        row["plan_call_device_busy_ms"] = busy
        row["plan_call_idle_share"] = (None if busy is None
                                       else 1.0 - busy / row["plan_call_ms"])
        row["plan_call_device_top_ms"] = top
        rows.append(row)
        del c, av, bv
        print(f"phase 9 [{smi}]: " + json.dumps(row), flush=True)
    for name, a, b in esc_cells:
        runs = RUNS if name == ESC_CELLS[0][0] else 5
        row = {"cell": f"ESC {name}", "runs": runs,
               "alg1_peak_mb": peak_mb(lambda: pt.spgemm(a, b, alg=1))}
        for what, alg, cf in ESC_RUNS:
            key = what.replace(" cf=", "_cf")

            def call(alg=alg, cf=cf):
                return pt.spgemm(a, b, alg=alg, chunk_fraction=cf,
                                 impl="esc")

            row[f"{key}_peak_mb"] = peak_mb(call)
            row[f"{key}_ms"] = median_ms(call, runs)
            row[f"{key}_host_syncs"] = host_syncs(call)
        if name == ESC_CELLS[0][0]:
            busy, top = device_profile(
                lambda: pt.spgemm(a, b, alg=2, impl="esc"), calls=3)
            row["alg2_device_busy_ms"] = busy
            row["alg2_idle_share"] = (None if busy is None
                                      else 1.0 - busy / row["alg2_ms"])
            row["alg2_device_top_ms"] = top
        rows.append(row)
        torch.cuda.empty_cache()
        print(f"phase 9 [{smi}]: " + json.dumps(row), flush=True)
    return rows


# --------------------------------------------------------------------------
# blocked alg2/alg3 engines (phases 10-11)
# --------------------------------------------------------------------------

# (name, alg, chunk fraction) of the blocked calls, with the default impl
BLOCKED_RUNS = [("alg2", 2, 0.2), ("alg3 cf=0.2", 3, 0.2),
                ("alg3 cf=0.05", 3, 0.05)]
BLOCKED_KERNELS = ("densify_onehot", "densify_onehot_pattern", "extract_roll")


def with_engine(call):
    """(result, engine) of `call(verbose=True)`: the engine named on the
    blocked engines' verbose line ("scan" for alg2's and "scan2" for alg3's,
    whose lines, as in the JAX package, name none).  An empty product
    returns after sizing, before any engine runs or prints: "empty"."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c = call(verbose=True)
    lines = [x for x in buf.getvalue().splitlines() if "/blocked]" in x]
    if not lines and c.nnz == 0:
        return c, "empty"
    if len(lines) != 1:
        raise AssertionError(f"expected one blocked engine line, got "
                             f"{buf.getvalue()!r}")
    word = lines[0].split("] ", 1)[1].split()[0]
    if word.startswith("T="):
        word = "scan2" if "alg3" in lines[0] else "scan"
    return c, word


@contextlib.contextmanager
def alg2_engine(name: str):
    """Force the alg2 engine ("unrolled" or "scan") through its tile
    bound."""
    old = bl._ALG2_MAX_UNROLL_TILES
    bl._ALG2_MAX_UNROLL_TILES = 1 << 30 if name == "unrolled" else 0
    try:
        yield
    finally:
        bl._ALG2_MAX_UNROLL_TILES = old


def same_csr(x, y) -> bool:
    return (x.shape == y.shape and same_bits(x.indptr, y.indptr)
            and same_bits(x.indices, y.indices) and same_bits(x.data, y.data))


def phase10(dev):
    """The blocked engines: the pattern kernel against its plain version,
    every call against scipy, bitwise on rerun, the engines forced at
    1024^2/0.1; returns (launches, max |kernel - plain|, engines, cells)."""
    cells = make_cells(dev)
    pairs = cells + edge_pairs(dev)
    err = 0.0
    for name, a, b in pairs:
        for x in (a, b):
            got = densify_onehot_pattern(x.indptr, x.indices, *x.shape)
            want = densify_onehot_pattern_plain(x.indptr, x.indices,
                                                *x.shape)
            if not same_bits(got, want):
                raise AssertionError(f"densify_onehot_pattern != plain at "
                                     f"{name} {tuple(x.shape)}")
            err = max(err, max_abs(got, want))
            del got, want
    torch.cuda.synchronize()
    refs = {name: ScipyRef(a, b) for name, a, b in pairs}
    _build.reset_launches()
    outs = []
    for name, a, b in pairs:
        for what, alg, cf in BLOCKED_RUNS:
            c, engine = with_engine(
                lambda verbose, a=a, b=b, alg=alg, cf=cf: pt.spgemm(
                    a, b, alg=alg, chunk_fraction=cf, verbose=verbose))
            again = pt.spgemm(a, b, alg=alg, chunk_fraction=cf)
            outs.append((name, (a.shape[0], b.shape[1]), what, engine, c,
                         again))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    off_path = {k: v for k, v in launches.items()
                if v and k not in BLOCKED_KERNELS}
    if off_path or not all(launches[k] for k in BLOCKED_KERNELS):
        raise AssertionError(f"blocked launch counts {launches}: expected "
                             f"{BLOCKED_KERNELS} and nothing else")
    engines, notes = {}, []
    for name, shape, what, engine, c, again in outs:
        if not same_csr(c, again):
            raise AssertionError(f"{what} at {name}: rerun not bitwise")
        if tuple(c.shape) != shape or not c.has_canonical_format:
            raise AssertionError(f"{what} at {name}: bad output {c}")
        ratio = refs[name].check(f"{what} {name}", c)
        engines[f"{what} @ {name}"] = engine
        notes.append(f"{name} {what} [{engine}] nnz={c.nnz} "
                     f"err/tol={ratio:.3g}")
    del outs
    # every engine forced at 1024^2/0.1: each set bitwise within itself
    name, a, b = cells[0]
    forced = []
    with alg2_engine("unrolled"):
        u = pt.spgemm(a, b, alg=2)
    with alg2_engine("scan"):
        s2 = pt.spgemm(a, b, alg=2)
    if not same_csr(u, s2):
        raise AssertionError(f"alg2 unrolled != scan at {name}")
    forced.append("alg2 unrolled == scan")
    del u, s2
    for cf in (0.2, 0.05):
        c3 = [bl.spgemm_alg3_blocked(a, b, 1.0, cf, engine=e)
              for e in bl._ENGINES]
        refs[name].check(f"alg3 group cf={cf} {name}", c3[0])
        if not all(same_csr(c, c3[0]) for c in c3[1:]):
            raise AssertionError(f"alg3 engines differ at {name} cf={cf}")
        forced.append(f"alg3 cf={cf} {' == '.join(bl._ENGINES)}")
        del c3
    torch.cuda.synchronize()
    print(f"phase 10: densify_onehot_pattern bitwise at {2 * len(pairs)} "
          f"operands; launches {launches}; " + "; ".join(notes)
          + f"; forced at {name}: " + "; ".join(forced), flush=True)
    return launches, err, engines, cells


def alg2_passes(a, b):
    """(count pass, numeric pass) of the alg2 engine `spgemm` selects, each
    a function of no argument over inputs prepared once."""
    m, k = a.shape
    n = b.shape[1]
    m_pad = -(-m // bl.TILE) * bl.TILE
    T = m_pad // bl.TILE
    ip = bl._pad_indptr(a.indptr, m_pad)
    ip_h = bl._pad_indptr_h(a.indptr.cpu().numpy(), m_pad)

    def count():
        _, tilec, mask = bl._alg2_count(ip, a.indices, b.indptr, b.indices,
                                        m_pad, k, n, T)
        return tilec.cpu().numpy(), mask

    tilec_h, mask = count()
    nnz = int(tilec_h.sum())
    if T <= bl._ALG2_MAX_UNROLL_TILES:
        caps = [int(c) for c in tilec_h]
        return count, lambda: bl._alg2_compute_unrolled(
            ip, ip_h, a.indices, a.data, b.indptr, b.indices, b.data, mask,
            1.0, m, k, n, T, nnz, caps)
    del mask
    cap_tile = -(-int(tilec_h.max()) // 8) * 8
    return count, lambda: bl._alg2_compute(
        ip, a.indices, a.data, b.indptr, b.indices, b.data, 1.0, tilec_h, m,
        m_pad, k, n, T, cap_tile, nnz)


def alg3_passes(a, b, cf, engine):
    """(count pass, numeric pass) of the group and scan2 alg3 engines over
    inputs prepared once: the group engine counts with the host structural
    product, scan2 with its device sizing pass."""
    m, k = a.shape
    n = b.shape[1]
    n_b, P, _, m_pad, T = bl._alg3_grid(m, n, cf)
    host = [x.cpu().numpy() for x in (a.indptr, a.indices, b.indptr,
                                      b.indices)]
    blocks = bl._Blocks(a, b, host, n_b, P, m_pad)
    if engine == "group":
        indptr_h = bl._structural_product(a, b)[0]
        nnz = int(indptr_h[-1])
        bounds = np.minimum(np.arange(T + 1) * bl.TILE, m)
        caps = [int(indptr_h[bounds[t + 1]] - indptr_h[bounds[t]])
                for t in range(T)]
        G = max(1, min(T, bl._GROUP_STAGING_BYTES // (bl.TILE * n * 5)))
        return (lambda: bl._structural_product(a, b),
                lambda: bl._alg3_compute_group(blocks, 1.0, n, n_b, T, P, G,
                                               nnz, caps))
    if engine != "scan2":
        raise AssertionError(f"no pass split for the {engine} engine")

    def count():
        rowc, blockc = bl._alg3_count_fast(blocks, b.indptr, b.indices,
                                           n_b, T, P)
        return rowc, blockc.contiguous().cpu().numpy()

    rowc, blockc_h = count()
    cap_blk = max(-(-int(blockc_h.max()) // 8) * 8, 8)
    return count, lambda: bl._alg3_compute(
        blocks, rowc, blockc_h, 1.0, m, n, n_b, T, P, cap_blk,
        int(blockc_h.sum()))


def phase11(cells, engines, smi):
    """CUDA-event medians of alg1, every blocked engine and ESC with peak
    memory and host syncs per call, the passes apart, device busy time, and
    the pattern kernel; returns the rows."""
    rows = []
    for name, a, b in cells:
        slow = name == CELLS[1][0]  # the host structural product takes s
        runs, warmup = (5, 1) if slow else (RUNS, WARMUP)
        row = {"cell": name, "runs": runs}

        def measure(key, fn, n_runs=runs):
            row[f"{key}_peak_mb"] = peak_mb(fn)
            row[f"{key}_ms"] = median_ms(fn, n_runs, warmup)
            row[f"{key}_host_syncs"] = host_syncs(fn)

        measure("alg1", lambda: pt.spgemm(a, b, alg=1))
        default2 = engines[f"alg2 @ {name}"]
        row["alg2_engine"] = default2
        for e in ("unrolled", "scan"):
            def call2(e=e):
                with alg2_engine(e):
                    return pt.spgemm(a, b, alg=2)
            measure(f"alg2_{e}", call2, runs if e == default2 else 5)
        for what, alg, cf in BLOCKED_RUNS[1:]:
            default3 = engines[f"{what} @ {name}"]
            row[f"alg3_cf{cf}_engine"] = default3
            for e in bl._ENGINES:
                if slow and e not in (default3, "scan2"):
                    continue  # each would repeat seconds of host product
                measure(f"alg3_cf{cf}_{e}",
                        lambda e=e, cf=cf: bl.spgemm_alg3_blocked(
                            a, b, 1.0, cf, engine=e),
                        runs if e == default3 else 5)
        for what, alg, cf in ESC_RUNS:
            measure("esc_" + what.replace(" cf=", "_cf"),
                    lambda alg=alg, cf=cf: pt.spgemm(
                        a, b, alg=alg, chunk_fraction=cf, impl="esc"))
        torch.cuda.empty_cache()
        # the passes apart, for the engines `spgemm` takes
        count, numeric = alg2_passes(a, b)
        row["alg2_count_ms"] = median_ms(count, runs, warmup)
        row["alg2_numeric_ms"] = median_ms(numeric, runs, warmup)
        del count, numeric
        for cf in (0.2, 0.05):
            e = row[f"alg3_cf{cf}_engine"]
            count, numeric = alg3_passes(a, b, cf, e)
            clock = host_ms if e == "group" else median_ms
            row[f"alg3_cf{cf}_count_ms"] = clock(count, 3 if slow else runs)
            row[f"alg3_cf{cf}_numeric_ms"] = median_ms(numeric, runs, warmup)
            del count, numeric
        torch.cuda.empty_cache()
        calls = 3 if slow else 10
        for key, fn in (
                ("alg2", lambda: pt.spgemm(a, b, alg=2)),
                ("alg3_cf0.2", lambda: pt.spgemm(a, b, alg=3,
                                                 chunk_fraction=0.2))):
            busy, top = device_profile(fn, calls=calls)
            wall = row[f"{key}_{row[key + '_engine']}_ms"]
            row[f"{key}_device_busy_ms"] = busy
            row[f"{key}_idle_share"] = (None if busy is None
                                        else 1.0 - busy / wall)
            row[f"{key}_device_top_ms"] = top
        # the pattern kernel on B, against its plain version and torch's
        # CSR to_dense of bf16 ones
        k, n = b.shape
        ones = torch.ones(b.nnz, dtype=torch.bfloat16, device=b.device)
        tb = torch_csr(b.indptr, b.indices, ones, (k, n))
        args = (b.indptr, b.indices, k, n)
        row["pattern_nnz"] = b.nnz
        row["pattern_ms"] = median_ms(lambda: densify_onehot_pattern(*args))
        row["pattern_device_ms"] = kernel_ms(
            lambda: densify_onehot_pattern(*args), "densify_pattern_rows")
        row["pattern_plain_ms"] = median_ms(
            lambda: densify_onehot_pattern_plain(*args))
        row["pattern_library_ms"] = median_ms(tb.to_dense)
        del tb, ones
        # the (k, P n_b) pattern of B in the cf 0.2 alg3 sizing pass
        n_b, P = bl._alg3_grid(a.shape[0], n, 0.2)[:2]
        sizing = (b.indptr, b.indices, k, P * n_b)
        row["pattern_sizing_shape"] = [k, P * n_b]
        row["pattern_sizing_ms"] = median_ms(
            lambda: densify_onehot_pattern(*sizing))
        row["pattern_sizing_device_ms"] = kernel_ms(
            lambda: densify_onehot_pattern(*sizing), "densify_pattern_rows")
        rows.append(row)
        torch.cuda.empty_cache()
        print(f"phase 11 [{smi}]: " + json.dumps(row), flush=True)
    return rows


# --------------------------------------------------------------------------
# the containers slice: BSR SpMM and csr_densify_mxu (phases 12-13)
# --------------------------------------------------------------------------

# (name, n, block density, seed): the cells JAX measured bsr_spmm at
# (spmm_tpu/ops/kernels/bsr_spmm.py:15-23, 128x128 blocks of
# models.block_sparse, B of 256 columns) and one scaled to fill the card
BSR_CELLS = [("bsr 4096^2/0.05", 4096, 0.05, 2016),
             ("bsr 4096^2/0.15", 4096, 0.15, 2017),
             ("bsr 8192^2/0.02", 8192, 0.02, 2018),
             ("bsr 32768^2/0.02", 32768, 0.02, 2019)]
BSR_BLOCK = (128, 128)
BSR_N = 256
# the default route of via="bsr_pallas": a CSR re-tiled by tobsr() at
# (8, 128) (BASELINE.md:59)
BSR_CSR_CELL = "csr 8192^2/1e-3 -> (8,128)"
BSR_CSR = (8192, 1e-3, 2012)  # n, density, seed; also the round trips'
# (n, half-width, seed) of the band of the DIA round trip
DIA_BAND = (32768, 4, 2020)
# (name, m, k, density, seed) of csr_densify_mxu: BASELINE.md:20 and :59
MXU_CELLS = [("mxu 1024^2/0.1", 1024, 1024, 0.1, 2008),
             ("mxu 8192^2/1e-3", 8192, 8192, 1e-3, 2012)]
SLICE_KERNELS = ("bsr_spmm", "csr_densify_mxu")


def make_bsr_cells(dev):
    """(name, A as handed to spmm, X) of every BSR cell: the block cells as
    BSR, the CSR cell as CSR, and the edges (ragged K and N, an empty
    matrix, a block row with no blocks); X is N(0,1) from seed 2024."""
    rng = np.random.default_rng(2024)

    def dense(k, n):
        return torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32)).to(dev)

    cells = [(name, block_sparse(n, n, BSR_BLOCK, bd, seed=seed,
                                 device=dev).tobsr(BSR_BLOCK),
              dense(n, BSR_N)) for name, n, bd, seed in BSR_CELLS]
    n, d, seed = BSR_CSR
    cells.append((BSR_CSR_CELL, pt.random(n, n, d, format="csr", seed=seed,
                                          device=dev), dense(n, BSR_N)))
    cells.append(("edge 40x200 @ 200x70",
                  pt.random(40, 200, 0.1, format="csr", seed=2, device=dev),
                  dense(200, 70)))
    cells.append(("edge empty 16x256", pt.CSR((16, 256), device=dev),
                  dense(256, 128)))
    c = pt.random(24, 256, 0.05, seed=5, device=dev)
    keep = c.row >= 8  # block row 0 at (8, 128) holds no block
    cells.append(("edge empty block row",
                  pt.COO((c.data[keep], (c.row[keep], c.col[keep])),
                         shape=c.shape).tocsr(), dense(256, 128)))
    return cells


def make_mxu_cells(dev):
    cells = [(name, pt.random(m, k, d, format="csr", seed=seed, device=dev))
             for name, m, k, d, seed in MXU_CELLS]
    cells.append(("mxu powerlaw 200x300",
                  power_law_rows(200, 300, 20, seed=3, device=dev)))
    cells.append(("mxu empty 16x32", pt.CSR((16, 32), device=dev)))
    return cells


def as_bsr(a):
    return a if isinstance(a, pt.BSR) else a.tobsr()


def within_abs_sum(y, ref, scale) -> float:
    """Worst |y - ref| / (1e-6 (|A| @ |X|)) of a product: two float32
    orders of the same L products differ by O(L eps) of the entry's
    absolute sum, not of the entry or of max|C| (phase 4's bound)."""
    err = np.abs(y.cpu().double().numpy() - ref)
    tol = 1e-6 * scale
    if np.any(err[tol == 0] != 0):
        raise AssertionError("a product with no terms is not 0")
    return float(np.max(err[tol > 0] / tol[tol > 0], initial=0.0))


def phase12(dev):
    """The slice's kernels against their plain versions (bsr_spmm within
    1e-6 of each entry's absolute sum and bitwise on rerun;
    csr_densify_mxu bitwise, also against toarray()), then the main path
    with launch counts: spmm(via="bsr_pallas"), spmm(via="bsr"),
    spmm(A_bsr, X) and A_bsr @ X against scipy's float64 product, and
    csr_densify_mxu; then full-size COO/CSR/CSC/BSR/DIA round trips against
    scipy.  Returns (launches, max |kernel - plain|, cells, mxu cells)."""
    cells, mxu = make_bsr_cells(dev), make_mxu_cells(dev)
    err = {k: 0.0 for k in SLICE_KERNELS}
    notes, refs = [], {}
    for name, a, x in cells:
        ab, m = as_bsr(a), a.shape[0]
        args = (ab.indptr, ab.indices, ab.data, x, m)
        got, again = bsr_spmm(*args), bsr_spmm(*args)
        want = bsr_spmm_plain(*args)
        scale = bsr_spmm_plain(ab.indptr, ab.indices, ab.data.abs(),
                               x.abs(), m).double()
        if not same_bits(got, again):
            raise AssertionError(f"bsr_spmm at {name}: rerun not bitwise")
        diff = (got - want).abs().double()
        if bool((diff > 1e-6 * scale).any()):
            raise AssertionError(f"bsr_spmm != plain at {name}: worst "
                                 f"{float(diff.max())}")
        gate = float((diff / (1e-6 * scale).clamp_min(1e-30)).max()) \
            if diff.numel() else 0.0
        # the form rtol 1e-5, atol 1e-6 max|C|, for the record only
        issue_form = float((diff / (1e-5 * want.abs().double() + 1e-6 * float(
            want.abs().max()) + 1e-30)).max()) if want.numel() else 0.0
        err["bsr_spmm"] = max(err["bsr_spmm"], max_abs(got, want))
        s = a.to_scipy().astype(np.float64)
        xh = x.cpu().double().numpy()
        refs[name] = (s @ xh, abs(s) @ np.abs(xh))
        notes.append(f"{name} nblocks={ab.nblocks} block={ab.blocksize} "
                     f"|k-plain|={max_abs(got, want):.3g} "
                     f"({gate:.3g} of 1e-6 |A||X|, kernel vs scipy "
                     f"{within_abs_sum(got, *refs[name]):.3g}; "
                     f"rtol1e-5/atol1e-6max form {issue_form:.3g})")
        del got, again, want, scale, diff
    for name, a in mxu:
        args = (a.indptr, a.indices, a.data, *a.shape)
        got = csr_densify_mxu(*args)
        if not (same_bits(got, csr_densify_mxu_plain(*args))
                and same_bits(got, a.toarray())):
            raise AssertionError(f"csr_densify_mxu not bitwise at {name}")
        del got
    torch.cuda.synchronize()
    # the main path, counted
    _build.reset_launches()
    outs = []
    for name, a, x in cells:
        ab = as_bsr(a)
        outs.append((name, [("via=bsr_pallas", pt.spmm(a, x,
                                                         via="bsr_pallas")),
                            ("via=bsr", pt.spmm(a, x, via="bsr")),
                            ("spmm(A_bsr)", pt.spmm(ab, x)),
                            ("A_bsr @ X", ab @ x)]))
    for name, a in mxu:
        outs.append((name, csr_densify_mxu(a.indptr, a.indices, a.data,
                                           *a.shape)))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if not all(launches[k] for k in SLICE_KERNELS):
        raise AssertionError(f"slice launch counts {launches}: expected "
                             f"{SLICE_KERNELS} launched")
    worst = 0.0
    for name, out in outs:
        if name not in refs:
            continue
        for what, y in out:
            ratio = within_abs_sum(y, *refs[name])
            if ratio > 1.0:
                raise AssertionError(f"{what} at {name}: {ratio:.3g} of "
                                     "1e-6 |A||X|")
            worst = max(worst, ratio)
    del outs, refs
    trips = round_trips(dev)
    torch.cuda.synchronize()
    print(f"phase 12: launches {launches}; bsr_spmm within 1e-6 |A||X| of "
          f"plain and bitwise on rerun: " + "; ".join(notes)
          + f"; csr_densify_mxu bitwise vs plain and toarray at {len(mxu)} "
          f"cells; entry points vs scipy f64: worst {worst:.3g} of "
          f"1e-6 |A||X|; round trips: {trips}", flush=True)
    return launches, err, cells, mxu


def _same_arrays(name, pairs):
    for what, got, want in pairs:
        g, w = got.cpu().numpy(), np.asarray(want)
        if g.shape != w.shape or not np.array_equal(
                g.view(np.uint8), w.astype(g.dtype).view(np.uint8)):
            raise AssertionError(f"round trip {name}: {what} differs from "
                                 "scipy")


def round_trips(dev) -> str:
    """COO -> CSR -> CSC -> BSR -> COO -> CSR at 8192^2/1e-3 and CSR -> DIA
    -> CSR at a 32768^2 band, each format's arrays bitwise against
    scipy's conversion of the same matrix."""
    n, dens, seed = BSR_CSR
    a = pt.random(n, n, dens, seed=seed, device=dev)
    s = a.to_scipy()
    csr, s_csr = a.tocsr(), s.tocsr()
    csc, s_csc = csr.tocsc(), s.tocsc()
    bsr, s_bsr = csc.tobsr(), s_csr.tobsr(blocksize=(8, 128))
    s_bsr.sort_indices()  # scipy stores a block row's blocks as met
    back = bsr.tocoo().tocsr()
    for name, got, want in (("csr", csr, s_csr), ("csc", csc, s_csc),
                            ("bsr", bsr, s_bsr),
                            ("bsr->coo->csr", back, s_csr)):
        _same_arrays(name, [("indptr", got.indptr, want.indptr),
                            ("indices", got.indices, want.indices),
                            ("data", got.data, want.data)])
    nb, half, seed = DIA_BAND
    band = banded(nb, nb, half, seed=seed, device=dev)
    d, s_d = band.todia(), band.to_scipy().todia()
    if list(d._offsets) != s_d.offsets.tolist():
        raise AssertionError("round trip dia: offsets differ from scipy")
    _same_arrays("dia", [("toarray band", d.tocsr().data,
                          s_d.tocsr().data),
                         ("dia->csr indices", d.tocsr().indices,
                          s_d.tocsr().indices),
                         ("transpose", d.T.tocsr().data,
                          s_d.T.tocsr().data)])
    return (f"COO->CSR->CSC->BSR->COO->CSR at {n}^2/{dens} (nnz {a.nnz}, "
            f"{bsr.nblocks} blocks) and CSR->DIA->CSR at a {nb}^2 band "
            f"({len(d._offsets)} diagonals) bitwise against scipy")


def phase13(cells, mxu, smi):
    """CUDA-event medians at the slice's cells: bsr_spmm, its plain version
    (the via="bsr" route's arithmetic), torch's BSR @ dense, spmm's two BSR
    routes; the conversions; device busy time and idle share of
    spmm(via="bsr_pallas"); csr_densify_mxu alone and through its checks,
    its plain version, torch's CSR to_dense() and densify_onehot."""
    rows = []
    for name, a, x in cells:
        if name.startswith("edge"):
            continue
        ab, m = as_bsr(a), a.shape[0]
        args = (ab.indptr, ab.indices, ab.data, x, m)
        R, C = ab.blocksize
        row = {"cell": name, "m": m, "k": a.shape[1], "n": x.shape[1],
               "blocksize": [R, C], "nblocks": ab.nblocks,
               "block_rows": ab.indptr.numel() - 1}
        row["bsr_spmm_ms"] = median_ms(lambda: bsr_spmm(*args))
        row["bsr_spmm_device_ms"] = kernel_ms(lambda: bsr_spmm(*args),
                                              "bsr_spmm_tc")
        row["bsr_spmm_plain_ms"] = median_ms(lambda: bsr_spmm_plain(*args))
        nbytes = 4 * (ab.nblocks * R * C + x.numel() + row["block_rows"]
                      * R * x.shape[1] + row["block_rows"] + 1 + ab.nblocks)
        flops = 2 * ab.nblocks * R * C * x.shape[1]
        # the kernel's route: three TF32 products a multiply-add; beside it
        # what the FMA units alone would allow
        row["bound_ms"], row["bound_by"] = bound(nbytes, 3 * flops,
                                                 TF32_FLOPS)
        row["fp32_fma_bound_ms"] = bound(nbytes, flops)[0]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # beta notices
            tb = torch.sparse_bsr_tensor(ab.indptr.long(), ab.indices.long(),
                                         ab.data, ab.shape)
        try:
            row["library_ms"] = median_ms(lambda: tb @ x)
        except (RuntimeError, NotImplementedError) as e:
            row["library_ms"], row["library_error"] = None, str(e)[:120]
        del tb
        row["spmm_bsr_pallas_ms"] = median_ms(
            lambda: pt.spmm(a, x, via="bsr_pallas"))
        row["spmm_bsr_ms"] = median_ms(lambda: pt.spmm(ab, x, via="bsr"))
        if name in (BSR_CSR_CELL, BSR_CELLS[-1][0]):
            csr = a if name == BSR_CSR_CELL else ab.tocsr()
            row["csr_nnz"] = csr.nnz
            row["tobsr_ms"] = median_ms(lambda: csr.tobsr((R, C)), 5, 1)
            row["tocoo_tocsr_ms"] = median_ms(lambda: csr.tocoo().tocsr(),
                                              5, 1)
            row["tocsc_ms"] = median_ms(csr.tocsc, 5, 1)
            # a trace of a few one-kernel calls can come back with no
            # device events: take a longer one then
            for calls in (5, 20):
                busy, top = device_profile(
                    lambda: pt.spmm(a, x, via="bsr_pallas"), calls=calls)
                if busy is not None:
                    break
            row["bsr_pallas_device_busy_ms"] = busy
            row["bsr_pallas_idle_share"] = (
                None if busy is None
                else 1.0 - busy / row["spmm_bsr_pallas_ms"])
            row["bsr_pallas_device_top_ms"] = top
            del csr
        rows.append(row)
        torch.cuda.empty_cache()
        print(f"phase 13 [{smi}]: " + json.dumps(row), flush=True)
    for name, a in mxu[:2]:
        m, k = a.shape
        args = (a.indptr, a.indices, a.data, m, k)
        row = {"cell": name, "m": m, "k": k, "nnz": a.nnz}
        row["mxu_ms"] = median_ms(lambda: densify_mxu_launch(*args))
        row["mxu_wrapper_ms"] = median_ms(lambda: csr_densify_mxu(*args))
        row["mxu_plain_ms"] = median_ms(lambda: csr_densify_mxu_plain(*args))
        tc = torch_csr(a.indptr, a.indices, a.data, (m, k))
        row["mxu_library_ms"] = median_ms(tc.to_dense)
        row["densify_onehot_ms"] = median_ms(lambda: densify_onehot(
            *args, with_pattern=False))
        rows.append(row)
        del tc
        torch.cuda.empty_cache()
        print(f"phase 13 [{smi}]: " + json.dumps(row), flush=True)
    return rows


# --------------------------------------------------------------------------
# indexing, dtypes and precision modes (phases 14-16)
# --------------------------------------------------------------------------

def event_ms(setup, fn, runs: int = 5) -> float:
    """Median CUDA-event time of fn(setup()) over `runs`, the setup outside
    the events (an assignment times on a fresh copy each run)."""
    times = []
    for _ in range(runs + 1):
        x = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def _same_result(got, want) -> bool:
    """A card result bitwise the CPU's: a CSR's structure, values and flag,
    or a dense tensor's bits."""
    if isinstance(want, torch.Tensor):
        return same_bits(got.cpu(), want)
    return (got.shape == want.shape
            and got.has_canonical_format == want.has_canonical_format
            and all(same_bits(x.cpu(), y) for x, y in (
                (got.indptr, want.indptr), (got.indices, want.indices),
                (got.data, want.data))))


def phase14(dev, smi):
    """Indexing on the card: each read and assignment bitwise the port's own
    CPU result for the same call, with its CUDA-event time."""
    rows = []
    mats = [("4000^2/0.0625", pt.random(4000, 4000, 0.0625, format="csr",
                                         seed=3, device="cpu")),
            ("16384^2/5e-3", pt.random(16384, 16384, 5e-3, format="csr",
                                        seed=2014, device="cpu"))]
    for name, a_cpu in mats:
        a = a_cpu.to(dev)
        m, n = a.shape
        rng = np.random.default_rng(14)
        keys = {
            "row slice": slice(m // 8, m - m // 8),
            "row array": rng.integers(0, m, m // 4),
            "column slice": (slice(None), slice(n // 4, n // 2)),
            "every 7th column": (slice(None), np.arange(0, n, 7)),
            "boolean rows": rng.random(m) < 0.3,
            "pairs": (rng.integers(0, m, 100_000), rng.integers(0, n, 100_000)),
        }
        row = {"cell": name, "nnz": a.nnz}
        for label, key in keys.items():
            got, want = a[key], a_cpu[key]
            if not _same_result(got, want):
                raise AssertionError(f"{name}: a[{label}] on the card differs "
                                     "from the CPU's")
            row[f"{label}_ms"] = median_ms(lambda k=key: a[k], runs=5,
                                           warmup=1)
        b_cpu = pt.random(m // 4, n // 4, 0.01, format="csr", seed=15,
                          device="cpu")
        b = b_cpu.to(dev)
        sub = (slice(m // 8, m // 8 + m // 4), slice(n // 2, n // 2 + n // 4))

        def assign(x, bb):
            x[sub] = bb
            return x

        def setdiag(x):
            x.setdiag(2.5, k=1)
            return x

        for label, on_card, on_cpu in (
                ("submatrix assignment", lambda x: assign(x, b),
                 lambda x: assign(x, b_cpu)),
                ("setdiag", setdiag, setdiag)):
            if not _same_result(on_card(a.copy()), on_cpu(a_cpu.copy())):
                raise AssertionError(f"{name}: {label} on the card differs "
                                     "from the CPU's")
            row[f"{label}_ms"] = event_ms(a.copy, on_card)
        rows.append(row)
        print(f"phase 14 [{smi}]: bitwise the CPU's: " + json.dumps(row),
              flush=True)
        del a, b
    return rows


WIDE = {"float64": torch.float64, "complex64": torch.complex64,
        "complex128": torch.complex128, "bfloat16": torch.bfloat16}


def as_dtype(a, dtype):
    """The matrix in `dtype`; a complex one gets its values reversed as the
    imaginary part, so both parts are non-trivial."""
    if dtype.is_complex:
        return a._with_data(torch.complex(a.data.float(),
                                          a.data.flip(0).float()).to(dtype))
    return a.astype(dtype)


def tensor_as(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype.is_complex:
        return torch.complex(x.float(), -x.float()).to(dtype)
    return x.to(dtype)


def wide_check(name, a, b, c, dtype) -> float:
    """Structure bitwise against scipy's pattern product; values within
    the JAX dtype tests' tolerance of scipy's product of the same values
    in complex128 (1e-5 x max|C| up to 8-byte types, 1e-12 for complex128;
    bfloat16 0.05 + 0.05 |C|).  Returns max |err| / tolerance."""
    sa, sb = a.to_scipy(), b.to_scipy()
    ones = [sp.csr_matrix((np.ones(x.nnz), x.indices, x.indptr), x.shape)
            for x in (sa, sb)]
    struct = (ones[0] @ ones[1]).tocsr()
    struct.sort_indices()
    if not (np.array_equal(c.indptr.cpu().numpy(), struct.indptr)
            and np.array_equal(c.indices.cpu().numpy(), struct.indices)):
        raise AssertionError(f"{name}: structure differs from scipy")
    ref = (sa.astype(np.complex128) @ sb.astype(np.complex128)).tocsr()
    rows = np.repeat(np.arange(a.shape[0]), np.diff(struct.indptr))
    want = np.asarray(ref[rows, struct.indices.astype(np.int64)]).ravel()
    got = c.data.cpu()
    got = (got.float() if dtype == torch.bfloat16 else got).numpy()
    if dtype == torch.bfloat16:
        tol = 0.05 + 0.05 * np.abs(want)
    else:
        rel = 1e-12 if dtype == torch.complex128 else 1e-5
        tol = np.full(want.shape, rel * np.abs(want).max())
    ratio = float((np.abs(got - want) / tol).max()) if want.size else 0.0
    if ratio > 1.0:
        raise AssertionError(f"{name}: off scipy by {ratio:.3g}x the "
                             "tolerance")
    return ratio


def kernel_counts(fn, names):
    """Launches per call of `fn` of each kernel whose name holds one of
    `names`, from a profiler trace of 20 calls, or of 100 where that trace
    came back without device events (as `kernel_ms`)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for calls in (20, 100):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if seen:
            return {n: sum(n in k for k in seen) / calls for n in names}
    return dict.fromkeys(names)


def bsr_fma_check(dev, a32, smi) -> dict:
    """bsr_spmm's FMA kernel (bfloat16, float64, int32) at the (8, 128)
    re-tiling of `a32` times an (n, SPMM_K) X and at a ragged edge, against
    the plain version of the same inputs on the CPU (where torch multiplies
    int32): bitwise for int32, within 1e-12 (float64) or 2^-6 (bfloat16) of
    each entry's absolute sum; bitwise on rerun; spmm(via="bsr_pallas")
    launches it.  A complex BSR raises, as JAX's kernel does."""
    rng = np.random.default_rng(2024)
    edge = pt.random(40, 200, 0.1, format="csr", seed=2, device=dev)
    mats = [(a32.tobsr((8, 128)), a32.shape[1], SPMM_K),
            (edge.tobsr((8, 128)), 200, 70)]
    xs = [torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(dev) for _, k, n in mats]
    row = {"cell": f"{CELLS[0][0]} -> (8,128) @ X (k={SPMM_K})",
           "kernel": "bsr_spmm_fma"}
    for label, dtype in (("bfloat16", torch.bfloat16),
                         ("float64", torch.float64), ("int32", torch.int32)):
        def conv(t):
            return (t * 8).round().to(dtype) if dtype == torch.int32 \
                else t.to(dtype)

        for (ab, _, _), x32 in zip(mats, xs):
            ab = ab._with_data(conv(ab.data))
            x = conv(x32)
            m = ab.shape[0]
            args = (ab.indptr, ab.indices, ab.data, x, m)
            before = _build.LAUNCHES["bsr_spmm"]
            got = bsr_spmm(*args)
            y = pt.spmm(ab, x, via="bsr_pallas")
            if _build.LAUNCHES["bsr_spmm"] != before + 2:
                raise AssertionError(f"bsr_spmm {label}: no launch")
            if not (same_bits(got, bsr_spmm(*args)) and same_bits(got, y)):
                raise AssertionError(f"bsr_spmm {label}: not bitwise on "
                                     "rerun")
            host = [t.cpu() for t in args[:4]]
            want = bsr_spmm_plain(*host, m)
            if dtype == torch.int32:
                ratio = 0.0 if same_bits(got.cpu(), want) else float("inf")
            else:
                scale = bsr_spmm_plain(*host[:2], host[2].double().abs(),
                                       host[3].double().abs(), m)
                rel = 2.0**-6 if dtype == torch.bfloat16 else 1e-12
                diff = (got.cpu().double() - want.double()).abs()
                ratio = float((diff / (rel * scale).clamp_min(1e-300))
                              .max()) if diff.numel() else 0.0
            if ratio > 1.0:
                raise AssertionError(f"bsr_spmm {label} != plain at "
                                     f"{tuple(ab.shape)}: {ratio:.3g}x tol")
            if m == a32.shape[0]:
                row[f"{label}_err_over_tol"] = ratio
                row[f"{label}_ms"] = median_ms(lambda: bsr_spmm(*args))
                row[f"{label}_plain_ms"] = (
                    None if dtype == torch.int32  # no int32 bmm on the card
                    else median_ms(lambda: bsr_spmm_plain(*args)))
    ab = mats[0][0]
    row["float32_ms"] = median_ms(
        lambda: bsr_spmm(ab.indptr, ab.indices, ab.data, xs[0], ab.shape[0]))
    abc = ab._with_data(ab.data.to(torch.complex64))
    try:
        pt.spmm(abc, xs[0].to(torch.complex64), via="bsr_pallas")
    except NotImplementedError:
        pass
    else:
        raise AssertionError("bsr_spmm of complex64 did not raise")
    print(f"phase 15 [{smi}]: bsr_spmm's FMA kernel vs plain: "
          + json.dumps(row), flush=True)
    return row


def phase15(dev, smi):
    """Dtypes: densify_rows and extract_roll bitwise against their plain
    versions at every element width and at phase 1's edges; bsr_spmm's
    FMA kernel against its plain version (`bsr_fma_check`); alg1 and
    blocked alg2 at 1024^2/0.1 in each wide dtype against scipy, with the
    kernels seen in a profiler trace; SpMV and SpMM in float64 at
    16384^2/5e-3; times beside float32's."""
    name, n, density, sa, sb = CELLS[0]
    a32 = pt.random(n, n, density, format="csr", seed=sa, device=dev)
    b32 = pt.random(n, n, density, format="csr", seed=sb, device=dev)
    mats = [a32, b32, edge_csr(dev), *densify_edges(dev)]
    edges = extract_edges(dev)
    checked = 0
    for dtype in (torch.float32, *WIDE.values()):
        for mat in mats:
            vals = tensor_as(mat.data, dtype)
            for with_pattern in (True, False):
                args = (mat.indptr, mat.indices, vals, *mat.shape)
                got = densify_onehot(*args, with_pattern=with_pattern)
                again = densify_onehot(*args, with_pattern=with_pattern)
                want = densify_onehot_plain(*args, with_pattern=with_pattern)
                if not all(same_bits(x, y) and same_bits(z, y)
                           for x, y, z in zip(got, want, again)):
                    raise AssertionError(f"densify at {dtype} != plain at "
                                         f"{mat.shape}")
                checked += 1
        for ename, c, mask in edges:
            cw = tensor_as(c, dtype)
            nnz = int(mask.sum())
            for cap in (nnz, nnz + 5, max(nnz - 5, 0), 0):
                got = extract_roll(cw, mask, cap)
                want = extract_roll_plain(cw, mask, cap)
                if not all(same_bits(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"extract at {dtype} != plain at "
                                         f"{ename} cap={cap}")
                checked += 1
    torch.cuda.synchronize()
    print(f"phase 15: densify_onehot and extract_roll bitwise their plain "
          f"versions at 2, 4, 8 and 16 bytes: {checked} calls over "
          f"{len(mats)} CSRs and {len(edges)} masks", flush=True)
    rows = [bsr_fma_check(dev, a32, smi)]
    for label, dtype in (("float32", torch.float32), *WIDE.items()):
        a, b = as_dtype(a32, dtype), as_dtype(b32, dtype)
        row = {"cell": name, "dtype": label}
        for alg in (1, 2):
            c = pt.spgemm(a, b, alg=alg)
            row[f"alg{alg}_err_over_tol"] = wide_check(
                f"{name} alg{alg} {label}", a, b, c, dtype)
            if c.dtype != dtype:
                raise AssertionError(f"alg{alg} {label} gave {c.dtype}")
            row[f"alg{alg}_ms"] = median_ms(lambda: pt.spgemm(a, b, alg=alg))
        seen = kernel_counts(lambda: pt.spgemm(a, b, alg=1),
                             ("densify_rows", "extract_tiles"))
        row["alg1_trace_per_call"] = seen
        if not (seen["densify_rows"] and seen["extract_tiles"]):
            raise AssertionError(f"alg1 {label}: the kernels are missing "
                                 f"from its trace: {seen}")
        m, k = a.shape
        dens = (a.indptr, a.indices, a.data, m, k)
        row["densify_device_ms"] = kernel_ms(lambda: densify_onehot(*dens),
                                             "densify_rows")
        cd, mask, nnz = sg._alg1_dense_compute(a, b, 1.0)
        nnz = int(nnz)
        row["extract_device_ms"] = kernel_ms(
            lambda: extract_roll(cd, mask, nnz), "extract_tiles")
        del cd, mask
        rows.append(row)
        print(f"phase 15 [{smi}]: " + json.dumps(row), flush=True)
    a_mv = pt.random(16384, 16384, 5e-3, format="csr", seed=2014, device=dev)
    rng = np.random.default_rng(2024)
    n_mv = a_mv.shape[1]
    x = torch.from_numpy(rng.standard_normal(n_mv)).to(dev)
    X = torch.from_numpy(rng.standard_normal((n_mv, SPMM_K))).to(dev)
    s64 = a_mv.to_scipy().astype(np.float64)
    mv = {"cell": "16384^2/5e-3"}
    for label, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        a, xv, Xv = a_mv.astype(dtype), x.to(dtype), X.to(dtype)
        y, Y = pt.spmv(a, xv), pt.spmm(a, Xv)
        if y.dtype != dtype or Y.dtype != dtype:
            raise AssertionError(f"spmv/spmm {label} gave {y.dtype}")
        for got, xx in ((y, xv), (Y, Xv)):
            xh = xx.cpu().double().numpy()
            ref, scale = s64 @ xh, abs(s64) @ np.abs(xh)
            bound = (1e-12 if dtype == torch.float64 else ROW_TOL) * scale
            if not (np.abs(got.cpu().double().numpy() - ref) <= bound).all():
                raise AssertionError(f"spmv/spmm {label} off scipy")
        if not (same_bits(pt.spmv(a, xv), y) and same_bits(pt.spmm(a, Xv), Y)):
            raise AssertionError(f"spmv/spmm {label} not bitwise on rerun")
        mv[f"spmv_{label}_ms"] = median_ms(lambda: pt.spmv(a, xv))
        mv[f"spmm_{label}_ms"] = median_ms(lambda: pt.spmm(a, Xv))
    rows.append(mv)
    print(f"phase 15 [{smi}]: within 1e-12 (float64) and 1e-6 (float32) of "
          "each row's |A||x| of scipy, bitwise on rerun: " + json.dumps(mv),
          flush=True)
    return rows


def phase16(smi):
    """Precision modes at full size: alg1 and spgemm_plan calls at
    1024^2/0.1 and 8192^2/1e-3 in "highest", "high" and "default"; time a
    call, device busy, the value GEMM's share of it, and the error against
    scipy's float64 product.  "high" must pass the gate of "highest" (rtol
    1e-6 + atol 1e-6 max|C|); "default" is gated at 1e-2 max|C| only."""
    rows = []
    dev = torch.device("cuda", 0)
    for name, n, density, sa, sb in (CELLS[0], CELLS[2]):
        a = pt.random(n, n, density, format="csr", seed=sa, device=dev)
        b = pt.random(n, n, density, format="csr", seed=sb, device=dev)
        ref = ScipyRef(a, b)
        want = ref.want
        scale = np.abs(want).max()
        gate = RTOL * np.abs(want) + RTOL * scale
        ad, _ = densify_onehot(a.indptr, a.indices, a.data, n, n,
                               with_pattern=False)
        bd, _ = densify_onehot(b.indptr, b.indices, b.data, n, n,
                               with_pattern=False)
        for mode in sg.PRECISIONS:
            plan = pt.spgemm_plan(a, b, precision=mode)
            for path, call in (("alg1", lambda: pt.spgemm(
                    a, b, alg=1, precision=mode)),
                    ("plan", lambda: plan(a.data, b.data))):
                c = call()
                if not (np.array_equal(c.indptr.cpu().numpy(), ref.indptr)
                        and np.array_equal(c.indices.cpu().numpy(),
                                           ref.indices)):
                    raise AssertionError(f"{name} {path} {mode}: structure")
                err = np.abs(c.data.cpu().double().numpy() - want)
                row = {"cell": name, "path": path, "mode": mode,
                       "max_err_over_max_c": float(err.max() / scale),
                       "share_outside_1e-6_gate": float((err > gate).mean()),
                       "ms": median_ms(call)}
                busy, top = device_profile(call)
                row["device_busy_ms"] = busy
                gemm, _ = device_profile(
                    lambda: sg._value_matmul(ad, bd, mode))
                row["gemm_device_ms"] = gemm
                row["gemm_share"] = (None if not busy or gemm is None
                                     else gemm / busy)
                row["device_top_ms"] = top[:3]
                rows.append(row)
                print(f"phase 16 [{smi}]: " + json.dumps(row), flush=True)
                if mode in ("highest", "high") and (err > gate).any():
                    raise AssertionError(f"{name} {path} {mode}: outside "
                                         "the 1e-6 gate")
                if mode == "default" and err.max() > 1e-2 * scale:
                    raise AssertionError(f"{name} {path} default: error "
                                         "past 1e-2 max|C|")
            del plan
        del ad, bd, a, b
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# the headline, the calibration, sddmm and io, the experiment suites (phases 17-20)
# --------------------------------------------------------------------------

# S of the sddmm check (n, density, seed), A (n, SDDMM_K), B (SDDMM_K, n)
SDDMM_CELL = (4096, 0.01, 2020)
SDDMM_K = 64
SDDMM_ALPHA = 1.5
GEMM_TOL = 1e-5  # phase 18's gate, relative to (|A||X|)_ij
# the suites' grids: the determinism suite cut from the reference's
# (sizes 32-1024 x 0.01-0.5 x seeds 1-10) to what the time limit allows;
# the cross-check at the reference's full grid (45 cases)
DET_ARGS = ["--sizes", "32", "128", "512", "1024",
            "--densities", "0.01", "0.1", "0.3", "--seeds", "1",
            "--algs", "1", "2", "3"]


def phase17(smi):
    """The headline, `spmm_tpu_torch.bench`'s measurement in-process: the
    captured `_alg1_fixed` graph is bitwise an eager call (bench raises
    otherwise), then its line."""
    from spmm_tpu_torch import bench

    line = bench.measure()
    if not line["graph_bitwise_eager"]:
        raise AssertionError("phase 17: the graph differs from eager")
    print(f"phase 17 [{smi}]: captured _alg1_fixed graph bitwise an eager "
          f"call; " + json.dumps(line), flush=True)
    return line


def phase18(dev, smi):
    """`calibrate_break_even` over its default grid into the build
    directory; then, with `tuning._DEFAULT_CACHE` pointed at that table,
    `matmul(mode="auto")` at the table's crossover (and above) takes the
    dense route (a `densify_onehot` launch, no `spmm_routed`), and at a
    quarter of it the sparse one; both against scipy's float64 product,
    per entry within GEMM_TOL of (|A||X|)_ij (float32 sums over K = 1024
    on either route).  The old table path and cache are restored after."""
    from spmm_tpu_torch.ops import dispatch
    from spmm_tpu_torch.utils import tuning

    path = _build.BUILD_DIR.parent / "break_even_torch.json"
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        table = tuning.calibrate_break_even(save_path=str(path))
    took = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        print(f"phase 18 [{smi}]: {line}", flush=True)
    print(f"phase 18 [{smi}]: table {json.dumps(table)} in {took:.1f} s",
          flush=True)
    size = min(table)
    d_hi = table[size]
    old = tuning._DEFAULT_CACHE
    routes = {}
    try:
        tuning._DEFAULT_CACHE = str(path)
        dispatch.reload_break_even()
        if dispatch.break_even_density(size, size, tuning.B_COLS) != d_hi:
            raise AssertionError("phase 18: dispatch does not read the "
                                 "calibrated table")
        x = torch.ones((size, tuning.B_COLS), device=dev)
        for want, density in (("dense", min(1.0, 1.01 * d_hi)),
                              ("sparse", d_hi / 4)):
            a = pt.random(size, size, density, format="csr", seed=2021,
                          device=dev)
            torch.cuda.synchronize()
            _build.reset_launches()
            y = pt.matmul(a, x)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            dense = launches["densify_onehot"] > 0
            sparse = launches["spmm_routed"] > 0
            took_route = ("dense" if dense and not sparse else
                          "sparse" if sparse and not dense else "both")
            ref = a.to_scipy().astype(np.float64) @ np.ones(
                (size, tuning.B_COLS))
            scale = (abs(a.to_scipy()).astype(np.float64)
                     @ np.ones((size, tuning.B_COLS)))
            ratio = float((np.abs(y.cpu().numpy() - ref)
                           / (GEMM_TOL * scale + 1e-30)).max())
            routes[want] = {"density": a.density, "route": took_route,
                            "densify_onehot": launches["densify_onehot"],
                            "spmm_routed": launches["spmm_routed"],
                            "err_over_gate": ratio}
            if took_route != want or ratio > 1.0:
                raise AssertionError(f"phase 18: at density {a.density} "
                                     f"(crossover {d_hi}) matmul took "
                                     f"{routes[want]}, expected {want}")
    finally:
        tuning._DEFAULT_CACHE = old
        dispatch.reload_break_even()
    print(f"phase 18: n={size}, crossover {d_hi}: matmul(mode='auto') "
          f"{json.dumps(routes)}", flush=True)
    return table


def sddmm_check(s, a, b, alpha) -> float:
    """The largest |got - want| / (1e-6 |alpha| |s_ij| (|A||B|)_ij) over
    S's entries, `want` scipy's float64; S's structure must be kept
    bitwise."""
    got = pt.sddmm(s, a, b, alpha=alpha)
    again = pt.sddmm(s, a, b, alpha=alpha)
    if not (same_bits(got.indptr, s.indptr)
            and same_bits(got.indices, s.indices)
            and same_bits(again.data, got.data)):
        raise AssertionError("phase 19: sddmm changed S's structure or its "
                             "bits on rerun")
    if s.nnz == 0:
        return 0.0
    rows = s.rows.long().cpu().numpy()
    cols = s.indices.long().cpu().numpy()
    a64 = a.double().cpu().numpy()
    b64 = b.double().cpu().numpy()
    sv = s.data.double().cpu().numpy()
    want = alpha * sv * np.einsum("ij,ji->i", a64[rows], b64[:, cols])
    gate = RTOL * abs(alpha) * np.abs(sv) * np.einsum(
        "ij,ji->i", np.abs(a64[rows]), np.abs(b64[:, cols]))
    err = np.abs(got.data.double().cpu().numpy() - want)
    return float((err / (gate + 1e-30)).max())


def phase19(dev, smi):
    """sddmm against scipy's float64 (within 1e-6 |alpha||s|(|A||B|)_ij,
    bitwise on rerun) at S = 4096^2/0.01, an empty S and k = 1, timed
    beside torch.sparse.sampled_addmm; a card matrix through the text and
    npz files and back bitwise; routed and binned plans of the SpMV
    16384^2/5e-3 cell saved, loaded onto the card, and their SpMV bitwise
    the built plans' twice in a row."""
    import tempfile

    from spmm_tpu_torch.sparse import io as spio

    n, density, seed = SDDMM_CELL
    rng = np.random.default_rng(seed)
    s = pt.random(n, n, density, format="csr", seed=seed, device=dev)

    def dense(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    a, b = dense(n, SDDMM_K), dense(SDDMM_K, n)
    errs = {
        f"{n}^2/{density} k={SDDMM_K}": sddmm_check(s, a, b, SDDMM_ALPHA),
        "empty S": sddmm_check(pt.random(n, n, 0.0, format="csr", seed=1,
                                         device=dev), a, b, SDDMM_ALPHA),
        "k=1": sddmm_check(s, dense(n, 1), dense(1, n), SDDMM_ALPHA),
    }
    if max(errs.values()) > 1.0:
        raise AssertionError(f"phase 19: sddmm outside its gate: {errs}")
    ones = torch_csr(s.indptr, s.indices, torch.ones_like(s.data), s.shape)
    nnz = s.nnz
    cell = f"{n}^2/{density} k={SDDMM_K}"
    row = {
        "cell": f"sddmm {cell}", "nnz": nnz,
        "err_over_gate": errs,
        "sddmm_ms": median_ms(lambda: pt.sddmm(s, a, b, alpha=SDDMM_ALPHA)),
        "sddmm_busy_ms": device_profile(
            lambda: pt.sddmm(s, a, b, alpha=SDDMM_ALPHA))[0],
        "sampled_addmm_ms": median_ms(
            lambda: torch.sparse.sampled_addmm(ones, a, b)),
        "sampled_addmm_busy_ms": device_profile(
            lambda: torch.sparse.sampled_addmm(ones, a, b))[0],
        # S read once (indptr, indices, values), A and B once, the values
        # written once; two flops an entry and column of A
        "bound": bound(4 * (n + 1) + 12 * nnz + 4 * SDDMM_K * 2 * n,
                       2 * nnz * SDDMM_K),
    }
    print(f"phase 19 [{smi}]: " + json.dumps(row), flush=True)

    notes = []
    with tempfile.TemporaryDirectory() as tmp:
        prefix = f"{tmp}/s"
        spio.save_csr_txt(prefix, s)
        spio.save_npz(prefix + ".npz", s)
        for what, back in (("text", spio.load_csr_txt(prefix)),
                           ("npz", spio.load_npz(prefix + ".npz"))):
            if not (back.device == s.device and back.shape == s.shape
                    and all(same_bits(x, y) for x, y in (
                        (back.indptr, s.indptr), (back.indices, s.indices),
                        (back.data, s.data)))):
                raise AssertionError(f"phase 19: the {what} file did not "
                                     "load back bitwise on the card")
            notes.append(f"{what} round trip bitwise on {back.device}")
        a16 = pt.random(16384, 16384, 5e-3, format="csr", seed=2014,
                        device=dev)
        x = torch.from_numpy(np.random.default_rng(2024).standard_normal(
            16384).astype(np.float32)).to(dev)
        for effort in ("auto", "fast"):
            plan = pt.spmv_plan(a16, effort=effort)
            path = f"{tmp}/plan_{effort}.npz"
            t0 = time.perf_counter()
            spio.save_spmv_plan(path, plan)
            t1 = time.perf_counter()
            loaded = spio.load_spmv_plan(path)
            t2 = time.perf_counter()
            want = pt.spmv(a16, x, plan=plan)
            runs = [pt.spmv(a16, x, plan=loaded) for _ in range(2)]
            if not all(same_bits(y, want) for y in runs):
                raise AssertionError(f"phase 19: the loaded {plan[0]} plan's "
                                     "spmv differs from the built plan's")
            notes.append(f"{plan[0]} plan of 16384^2/5e-3 saved in "
                         f"{t1 - t0:.2f} s, loaded onto {dev} in "
                         f"{t2 - t1:.2f} s, spmv bitwise twice")
    print("phase 19: " + "; ".join(notes), flush=True)
    return row


def phase20(smi):
    """The experiment suites on the card: the determinism suite (two processes per
    alg, each over the whole grid) and the native cross-check (45 cases);
    each must pass everything."""
    from spmm_tpu_torch.experiments import cross_check, deterministic

    report_dir = _build.BUILD_DIR.parent
    t0 = time.perf_counter()
    det_report = report_dir / "determinism_report_torch.txt"
    rc = deterministic.main(DET_ARGS + ["--device", "cuda", "--report",
                                        str(det_report)])
    det_s = time.perf_counter() - t0
    last = det_report.read_text().splitlines()[-1]
    if rc != 0 or last != "ALL DETERMINISTIC":
        raise AssertionError(f"phase 20: determinism suite said {last!r}")
    t0 = time.perf_counter()
    cc_report = report_dir / "cross_check_report_torch.txt"
    rc = cross_check.main(["--device", "cuda", "--report", str(cc_report)])
    cc_s = time.perf_counter() - t0
    rows = [r for r in cc_report.read_text().splitlines()
            if not r.startswith("#")]
    passed = sum(r.startswith("PASS") for r in rows)
    if rc != 0 or passed != len(rows) or len(rows) != 45:
        raise AssertionError(f"phase 20: cross-check passed {passed} of "
                             f"{len(rows)} cases")
    print(f"phase 20 [{smi}]: determinism ALL DETERMINISTIC "
          f"({' '.join(DET_ARGS)}) in {det_s:.1f} s; cross-check "
          f"{passed} of {len(rows)} cases PASS in {cc_s:.1f} s", flush=True)

# phase 21: the speed drivers at small grids; the hand-written kernels by
# the names of their CUDA functions (csrc/*.cu), for the profiler trace
P21_ALG_CELLS = [(1024, 0.1), (512, 0.5)]
P21_DENSE = ["--size", "1024", "2048", "--density", "0.001", "0.01", "0.1",
             "--runs", "5", "--busy-calls", "2"]
P21_SPMV = ["--size", "512", "--density", "0.1", "--runs", "3"]
P21_PROFILE = ["--size", "1024", "--density", "0.1", "--runs", "5",
               "--busy-calls", "2"]
P21_ERROR = ["error", "--sizes", "256", "512", "--densities", "0.1", "0.5"]
P21_FRACTION = ["fraction", "--size", "512", "--density", "0.1", "--ref",
                "f64"]
NE_TOL = 1e-6  # max |C1 - C3| (or |C3 - C_f64|) against max|C|
P21_FLAG = "--phase-21"  # run phase 21 alone, in the process it starts
P21_TIMEOUT_S = 300
KERNEL_FUNCS = {
    "densify_rows": "densify_onehot",
    "densify_pattern_rows": "densify_onehot_pattern",
    "extract_tiles": "extract_roll", "binned_spmv": "spmv_binned",
    "plan_count": "spmv_binned_plan", "plan_place": "spmv_binned_plan",
    "routed_spmv": "spmv_routed", "spmm_routed": "spmm_routed",
    "onehot_spmv": "spmv_onehot", "expand_routed": "expand_routed",
    "compress_routed": "compress_routed", "bsr_spmm": "bsr_spmm",
    "densify_tiles": "csr_densify_mxu",
    "segment_sum_inorder": "segment_sum"}


# the hand-written kernels each SpGEMM alg's path shows at phase 21's
# cells (alg3 takes the group engine there, which densifies values only)
SPGEMM_KERNELS = {1: ("densify_onehot", "extract_roll"),
                  2: ("densify_onehot", "densify_onehot_pattern",
                      "extract_roll"),
                  3: ("densify_onehot", "extract_roll")}


def traced_kernels(what, fn, want, phase="phase 21"):
    """The port's hand-written kernels seen in a profiler trace of 3 calls
    of `fn` (after one untraced call), or of 20 where that trace came back
    without device events (as `kernel_counts`); raises where both did, or
    where a kernel of `want` is not among them."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for calls in (3, 20):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    else:
        raise AssertionError(f"{phase}: the profiler's traces of {what} "
                             "hold no device event")
    seen = sorted({port for func, port in KERNEL_FUNCS.items()
                   if any(func in n for n in names)})
    missing = [k for k in want if k not in seen]
    if missing:
        raise AssertionError(f"{phase}: the trace of {what} lacks {missing} "
                             f"(it shows {seen})")
    return seen


def run_driver(main, argv):
    """(JSON rows, launches, seconds) of one driver's `main(argv)` on the
    card through `--json`, the launch counts set to 0 just before it and
    read just after; its text goes to the JSON lines only."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--json", "--device", "cuda"])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    rows = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]
    return rows, launches, took


def _positive(name, rows, keys):
    """Every row's `keys` (times on the card's events and from its
    profiler's traces, bytes) present and positive."""
    for r in rows:
        bad = [k for k in keys if not (r.get(k) is not None and r[k] > 0)]
        if bad:
            raise AssertionError(f"phase 21: {name} row {r} lacks a "
                                 f"positive {bad}")


def _launched(name, launches, kernels):
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 21: {name} launched none of "
                             f"{missing} ({launches})")


def phase21(dev, smi):
    """The speed drivers' `main()` at small grids (module docstring, item
    21); any missing row, non-positive time, product off scipy or error
    past its gate raises."""
    from spmm_tpu_torch.benchmarks import (alg_comparison,
                                           component_profile,
                                           dense_vs_sparse, spgemm_vs_spmv)
    from spmm_tpu_torch.experiments import numerical_error

    t_phase = time.perf_counter()
    out = {}
    # alg_comparison: one call of main per cell (a cell is not a product
    # of the two lists)
    alg_rows, alg_launches, alg_s, traces, errs = [], {}, 0.0, {}, {}
    for size, density in P21_ALG_CELLS:
        rows, launches, took = run_driver(alg_comparison.main, [
            "--size", str(size), "--density", str(density), "--runs", "5",
            "--busy-calls", "2", "--memory", "--device-loop"])
        cell = f"{size}^2/{density}"
        if sorted(r["alg"] for r in rows) != [1, 2, 3]:
            raise AssertionError(f"phase 21: alg_comparison {cell} rows "
                                 f"{rows}")
        _positive("alg_comparison alg1", rows[:1], ("serving_ms",))
        _positive("alg_comparison", rows,
                  ("median_ms", "per_call_ms", "busy_ms", "delta_hbm_bytes",
                   "peak_hbm_bytes", "cusparse_ms"))
        a, b = alg_comparison.operands(size, density, 2008, dev)
        cs = alg_comparison.products(a, b, (1, 2, 3), 0.2)
        ref = ScipyRef(a, b)
        for alg, c in cs.items():
            errs[f"{cell} alg{alg}"] = ref.check(
                f"phase 21 alg_comparison {cell} alg{alg}", c)
            if not (same_bits(c.indptr, cs[1].indptr)
                    and same_bits(c.indices, cs[1].indices)):
                raise AssertionError(f"phase 21: {cell} alg{alg}'s "
                                     "structure differs from alg1's")
        for alg in (1, 2, 3):
            traces[f"{cell} alg{alg}"] = traced_kernels(
                f"alg{alg} at {cell}",
                lambda alg=alg: pt.spgemm(a, b, alg=alg,
                                          chunk_fraction=0.2),
                SPGEMM_KERNELS[alg])
        del a, b, cs, ref
        alg_rows += rows
        alg_s += took
        for k, v in launches.items():
            alg_launches[k] = alg_launches.get(k, 0) + v
    _launched("alg_comparison", alg_launches,
              ("densify_onehot", "extract_roll", "densify_onehot_pattern"))
    out["alg_comparison"] = (len(alg_rows), alg_launches, alg_s, traces)
    for r in alg_rows:
        print(f"phase 21 [{smi}]: alg_comparison {r['size']}^2/"
              f"{r['density']} alg{r['alg']} ({r['engine']}): "
              f"{r['median_ms']:.4f} ms (back to back "
              f"{r['per_call_ms']:.4f}), busy {r['busy_ms']:.4f}, ΔPeak "
              f"{r['delta_hbm_bytes'] / 2**20:.1f} MB, fresh peak "
              f"{r['peak_hbm_bytes'] / 2**20:.1f} MB, torch CSR @ CSR "
              f"{r['cusparse_ms']:.4f} ms"
              + (f", CUDA graph {r['serving_ms']:.4f} ms"
                 if "serving_ms" in r else ""), flush=True)
    print(f"phase 21: alg 1-3 products of one structure, err/tol vs scipy "
          f"{json.dumps({k: round(v, 4) for k, v in errs.items()})}",
          flush=True)
    torch.cuda.empty_cache()

    # dense_vs_sparse: every size x density, both sides timed
    rows, launches, took = run_driver(dense_vs_sparse.main, P21_DENSE)
    if len(rows) != 6:
        raise AssertionError(f"phase 21: dense_vs_sparse gave {len(rows)} "
                             "rows, expected 6")
    _positive("dense_vs_sparse", rows, ("dense_ms", "sparse_ms",
                                        "dense_busy_ms", "sparse_busy_ms"))
    _launched("dense_vs_sparse", launches, ("densify_onehot_pattern",))
    a = pt.random(2048, 2048, 0.1, format="csr", seed=0, device=dev)
    b = pt.random(2048, 2048, 0.1, format="csr", seed=1, device=dev)
    trace = {"alg2 2048^2/0.1": traced_kernels(
        "alg2 at 2048^2/0.1", lambda: pt.spgemm(a, b, alg=2),
        SPGEMM_KERNELS[2])}
    del a, b
    out["dense_vs_sparse"] = (len(rows), launches, took, trace)
    print(f"phase 21 [{smi}]: dense_vs_sparse (ms dense / sparse, engine) "
          + "; ".join(f"{r['size']}/{r['density']}: {r['dense_ms']:.4f} / "
                      f"{r['sparse_ms']:.4f} {r['engine']}" for r in rows),
          flush=True)
    torch.cuda.empty_cache()

    # spgemm_vs_spmv: 9 pairs and 3 SpMV formats, host forked per repeat
    rows, launches, took = run_driver(spgemm_vs_spmv.main, P21_SPMV)
    ops = sorted((r["op"], r["pair"]) for r in rows)
    want = sorted([("spgemm", f"{x}@{y}") for x in spgemm_vs_spmv.FORMATS
                   for y in spgemm_vs_spmv.FORMATS]
                  + [("spmv", x) for x in spgemm_vs_spmv.FORMATS])
    if ops != want:
        raise AssertionError(f"phase 21: spgemm_vs_spmv rows {ops}")
    _positive("spgemm_vs_spmv", rows, ("cpu_ms", "cpu_warm_ms", "gpu_ms",
                                       "gpu_busy_ms"))
    _launched("spgemm_vs_spmv", launches, ("spmv_binned",))
    a_cpu = spgemm_vs_spmv.gen_cpu(512, 0.1, "csr", 0)
    b_cpu = spgemm_vs_spmv.gen_cpu(512, 0.1, "csr", 1)
    ah, bh = (spgemm_vs_spmv.triplets(x) for x in (a_cpu, b_cpu))
    v = np.random.default_rng(9).random(512, dtype=np.float32)
    trace = {"csr@csr": traced_kernels(
                 "csr@csr at 512^2/0.1", spgemm_vs_spmv.spgemm_op(
                     ah, bh, (512, 512), "csr", "csr", dev),
                 SPGEMM_KERNELS[1]),
             "spmv csr": traced_kernels(
                 "spmv csr at 512^2/0.1", spgemm_vs_spmv.spmv_op(
                     ah, (512, 512), "csr", v, dev),
                 ("spmv_binned", "spmv_binned_plan"))}
    out["spgemm_vs_spmv"] = (len(rows), launches, took, trace)
    print(f"phase 21 [{smi}]: spgemm_vs_spmv 512^2/0.1 (cpu first call / "
          f"cpu warm / gpu ms) "
          + "; ".join(f"{r['pair']}: {r['cpu_ms']:.3f} / "
                      f"{r['cpu_warm_ms']:.3f} / {r['gpu_ms']:.3f} (busy "
                      f"{r['gpu_busy_ms']:.3f})" for r in rows), flush=True)

    # component_profile: every stage, each with its busy time
    rows, launches, took = run_driver(component_profile.main, P21_PROFILE)
    if [r["stage"] for r in rows] != list(component_profile.STAGES):
        raise AssertionError(f"phase 21: component_profile stages "
                             f"{[r['stage'] for r in rows]}")
    _positive("component_profile", rows, ("ms", "busy_ms"))
    _launched("component_profile", launches,
              ("densify_onehot", "extract_roll", "spmv_binned",
               "spmm_routed", "densify_onehot_pattern"))
    a = pt.random(1024, 1024, 0.1, format="csr", seed=0, device=dev)
    xs = torch.ones((1024, 128), device=dev)
    trace = {"spmv": traced_kernels(
                 "spmv at 1024^2/0.1",
                 lambda: pt.spmv(a, torch.ones(1024, device=dev)),
                 ("spmv_binned", "spmv_binned_plan")),
             "spmm csr": traced_kernels(
                 "spmm at 1024^2/0.1, k = 128", lambda: pt.spmm(a, xs),
                 ("spmm_routed",))}
    del a, xs
    out["component_profile"] = (len(rows), launches, took, trace)
    print(f"phase 21 [{smi}]: component_profile 1024^2/0.1 (ms, busy) "
          + "; ".join(f"{r['stage']}: {r['ms']:.4f}, {r['busy_ms']:.4f}"
                      for r in rows), flush=True)
    torch.cuda.empty_cache()

    # numerical_error: the heatmap cells and chunk fractions within 1e-6
    for argv, n_rows in ((P21_ERROR, 4), (P21_FRACTION, 7)):
        rows, launches, took = run_driver(numerical_error.main, argv)
        if len(rows) != n_rows:
            raise AssertionError(f"phase 21: numerical_error {argv[0]} gave "
                                 f"{len(rows)} rows, expected {n_rows}")
        over = [r for r in rows
                if not r["max_err"] <= NE_TOL * r["max_abs_c"]]
        if over:
            raise AssertionError(f"phase 21: numerical_error past "
                                 f"{NE_TOL} max|C|: {over}")
        _launched(f"numerical_error {argv[0]}", launches,
                  ("densify_onehot", "extract_roll"))
        a, b = numerical_error.operands(256, 0.1, 0, dev)
        trace = {"alg1": traced_kernels(
                     "alg1 at 256^2/0.1", lambda: pt.spgemm(a, b, alg=1),
                     SPGEMM_KERNELS[1]),
                 "alg3 cf=0.3": traced_kernels(
                     "alg3 cf 0.3 at 256^2/0.1",
                     lambda: pt.spgemm(a, b, alg=3, chunk_fraction=0.3),
                     SPGEMM_KERNELS[3])}
        del a, b
        out[f"numerical_error {argv[0]}"] = (len(rows), launches, took,
                                             trace)
        print(f"phase 21 [{smi}]: numerical_error {argv[0]} "
              + "; ".join(f"{r['size']}^2/{r['density']} cf "
                          f"{r['chunk_fraction']}: max err "
                          f"{r['max_err']:.3e} (max|C| "
                          f"{r['max_abs_c']:.4g})" for r in rows),
              flush=True)
    for name, (n, launches, took, trace) in out.items():
        print(f"phase 21: {name}: {n} rows in {took:.1f} s; launches "
              f"{json.dumps(launches)}; kernels traced "
              f"{json.dumps(trace)}", flush=True)
    print(f"phase 21 [{smi}]: all drivers in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def phase21_apart(smi):
    """Phase 21 in a process of its own: this script with `P21_FLAG`, its
    output this script's.  In the process that has run phases 0-20 the
    profiler's traces miss kernels (phase 16's null GEMM times), so the
    busy times and the traced kernels come from a fresh process, as a
    driver run from the command line gets them.  A non-zero exit raises."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           P21_FLAG], timeout=P21_TIMEOUT_S)
    if done.returncode:
        raise AssertionError(f"phase 21: its process exited "
                             f"{done.returncode}")
    print(f"phase 21 [{smi}]: its process took "
          f"{time.perf_counter() - t0:.1f} s, start included", flush=True)


def phase21_main():
    """The process of phase 21: the card checked, the kernels' library
    loaded (built by phase 0), then `phase21`."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    _build.library()
    phase21(torch.device("cuda", 0), card_line())



# phase 22: distribution at world size 1 under NCCL on the card (NCCL
# refuses two ranks on one card); each sharded op held against the port's
# single-card op, in a process of its own as phase 21
P22_FLAG = "--phase-22"
P22_TIMEOUT_S = 240
P22_RUNS = 5
P22_MARK = "phase 22 launches: "  # the line the parent reads
# the kernels the phase's path must launch, and show in a profiler trace
P22_LAUNCHED = ("densify_onehot", "extract_roll", "segment_sum",
                "spmm_routed")
P22_TRACED = ("densify_onehot", "extract_roll", "segment_sum")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (0 for an empty want)."""
    if want.numel() == 0:
        return 0.0
    return max_abs(got, want) / max(float(want.double().abs().max()),
                                    1e-30)


def phase22_cells(dev):
    """The phase's operands, made from seeds: SpMV 16384^2/5e-3 (seed
    2014, as phase 4) with x and y N(0,1); SpMM 10000^2/0.01 (2015), k =
    64; SpGEMM 8192^2/1e-3, seeds 2012/2013 (BASELINE.md:59); the streamed
    SpMV at 2^20, density 5e-7 (footprint_curve.txt's cell, seed 0)."""
    rng = np.random.default_rng(2024)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    mv = pt.random(16384, 16384, 5e-3, format="csr", seed=2014, device=dev)
    mm = pt.random(10000, 10000, 0.01, format="csr", seed=2015, device=dev)
    a = pt.random(8192, 8192, 1e-3, format="csr", seed=2012, device=dev)
    b = pt.random(8192, 8192, 1e-3, format="csr", seed=2013, device=dev)
    big = pt.random(1 << 20, 1 << 20, 5e-7, format="csr", seed=0,
                    device=dev)
    return {"mv": (mv, normal(16384), normal(16384)),
            "mm": (mm, normal(10000, SPMM_K)), "gemm": (a, b),
            "stream": (big, normal(1 << 20))}


def p22_collectives(a, X, mesh):
    """Every collective of `parallel.collectives` once, under the group's
    backend: CSR `a` in the wire format through broadcast, scatter,
    all_to_all and gather, its sparse all-reduce, the dense all-reduce and
    reduce-scatter of `X`, and a barrier.  Returns what each gave back, as
    (CSR, dense, dense)."""
    from spmm_tpu_torch.parallel import collectives as pc

    parts = pc.pad_csr(a, a.nnz + 4096)
    wires = [pc.broadcast_csr(parts, mesh, "rows"),
             pc.scatter_csr([a], mesh, "rows"),
             tuple(t[0] for t in pc.all_to_all_csr(
                 tuple(t[None] for t in parts), mesh, "rows"))]
    csrs = [pc.unpad_csr(*w[:3], int(w[3]), a.shape) for w in wires]
    csrs += pc.gather_csr(parts, mesh, "rows", shape=a.shape)
    csrs.append(pc.all_reduce_csr(a, mesh, "rows"))
    pc.barrier(mesh, "rows")
    return (csrs, pc.psum_dense(X, mesh, "rows"),
            pc.reduce_scatter_dense(X, mesh, "rows"))


# the collectives the phase's path must hand to the backend, by the names
# of ProcessGroupNCCL's host events in a profiler trace ("nccl:<name>")
P22_COLLECTIVES = ("all_gather", "all_to_all", "broadcast", "scatter",
                   "all_reduce")


def backend_calls(fns, backend):
    """The collectives of one profiler trace of `fns`, by the process
    group's own host events ("<backend>:<collective>"), and the device
    events under them (NCCL's kernels and copies).  Raises where a
    collective of `P22_COLLECTIVES` is not among the host events."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    host = sorted({e.name for e in prof.events()
                   if e.name.startswith(backend + ":")})
    device = sorted({e.name[:60] for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and ("nccl" in e.name.lower()
                          or e.name.startswith("Memcpy"))})
    missing = [c for c in P22_COLLECTIVES
               if not any(c in n for n in host)]
    if missing:
        raise AssertionError(f"phase 22: no {backend} call of {missing} in "
                             f"the trace (host: {host}; device: {device})")
    return host, device


def phase22(dev, smi):
    """Every sharded op of `spmm_tpu_torch.parallel` at world size 1 under
    NCCL (module docstring, item 22): held against the single-card op,
    launches counted over the main path, the kernels seen in a profiler
    trace, ms a call, busy ms and peak MB per op.  Any gap raises."""
    import tempfile

    from spmm_tpu_torch import parallel as pp
    from spmm_tpu_torch.parallel import summa

    t_phase = time.perf_counter()
    cells = phase22_cells(dev)
    tmp = tempfile.TemporaryDirectory()  # the FileStore's, for the group
    pp.init_process_group(store_path=os.path.join(tmp.name, "store"),
                          world_size=1, rank=0)
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            raise AssertionError(f"phase 22: the group runs {backend}")
        mesh, mesh2 = pp.make_mesh(1), summa.make_mesh_2d(1, 1)
        mv, x, y = cells["mv"]
        mm, X = cells["mm"]
        a, b = cells["gemm"]
        big, xb = cells["stream"]
        sh_mv = pp.shard_csr(mv, mesh, balance="nnz")
        sh_mm = pp.shard_csr(mm, mesh, balance="nnz")
        sh_a, sh_b = pp.shard_csr(a, mesh), pp.shard_csr(b, mesh)
        sh_big = pp.shard_csr(big, mesh, balance="nnz")
        plan = pp.spmv_stream_plan(sh_big, mesh)
        xs = pp.shard_vector(xb, mesh)
        bd = b.toarray()
        s_a = pp.shard_csr(a, mesh2, axis="x")
        s_b = pp.shard_csr(b, mesh2, axis="y")
        sh_mm.routed_plan()  # made once per shard, as a plan is
        ops = {
            "spmv_sharded": lambda: pp.spmv_sharded(sh_mv, x, mesh),
            "spmv_t_sharded": lambda: pp.spmv_t_sharded(sh_mv, y, mesh),
            "spmm_sharded": lambda: pp.spmm_sharded(sh_mm, X, mesh),
            "spgemm_dense_sharded": lambda: pp.spgemm_dense_sharded(
                sh_a, bd, mesh),
            "spgemm_sharded_sparse(stream_b)": lambda:
                pp.spgemm_sharded_sparse(sh_a, sh_b, mesh, stream_b=True),
            "spgemm_sharded_sparse(all_gather)": lambda:
                pp.spgemm_sharded_sparse(sh_a, sh_b, mesh, stream_b=False),
            "spmv_sharded_streamed": lambda: pp.spmv_sharded_streamed(
                plan, xs, mesh),
            "spmv_sharded_blocked": lambda: pp.spmv_sharded_blocked(
                plan, xb, mesh),
            "spgemm_summa": lambda: pp.spgemm_summa(s_a, s_b, mesh2),
            "spgemm_summa_sparse": lambda: summa.spgemm_summa_sparse(
                s_a, s_b, mesh2),
            "sparse_collectives": lambda: p22_collectives(mv, X, mesh),
        }
        # the main path, counted: the counts set to 0 just before it and
        # read just after
        torch.cuda.synchronize()
        _build.reset_launches()
        outs = {k: fn() for k, fn in ops.items()}
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        missing = [k for k in P22_LAUNCHED if not launches.get(k)]
        if missing:
            raise AssertionError(f"phase 22: the path launched none of "
                                 f"{missing} ({launches})")
        # the single-card ops on the same operands
        c1 = pt.spgemm(a, b, alg=1)
        c1_dense = c1.toarray()
        errs = {
            "spmv_sharded": rel_err(outs["spmv_sharded"], pt.spmv(mv, x)),
            "spmv_t_sharded": rel_err(outs["spmv_t_sharded"],
                                      pt.spmv(mv, y, transa=True)),
            "spmm_sharded": rel_err(outs["spmm_sharded"], pt.spmm(mm, X)),
            "spgemm_dense_sharded": rel_err(outs["spgemm_dense_sharded"],
                                            c1_dense),
            "spmv_sharded_streamed": rel_err(outs["spmv_sharded_streamed"],
                                             pt.spmv(big, xb)),
            "spgemm_summa": rel_err(outs["spgemm_summa"], c1_dense),
        }
        errs["spmv_sharded_blocked"] = errs["spmv_sharded_streamed"]
        for k in ("spgemm_sharded_sparse(stream_b)",
                  "spgemm_sharded_sparse(all_gather)"):
            c = pp.sharded_to_csr(outs[k])
            if not (same_bits(c.indptr, c1.indptr)
                    and same_bits(c.indices, c1.indices)):
                raise AssertionError(f"phase 22: {k}'s structure is not "
                                     "alg1's")
            errs[k] = rel_err(c.data, c1.data)
        kept = c1.data != 0  # the block compression keeps the nonzeros
        cs = summa.summa_blocks_to_csr(outs["spgemm_summa_sparse"],
                                       c1.shape, mesh2)
        if not same_bits(cs.indices, c1.indices[kept]):
            raise AssertionError("phase 22: the SUMMA blocks' structure is "
                                 "not alg1's")
        errs["spgemm_summa_sparse"] = rel_err(cs.data, c1.data[kept])
        csrs, psum, rsc = outs["sparse_collectives"]
        for c in csrs:  # moved bits, summed from +0.0 by the all-reduce
            if not (same_bits(c.indptr, mv.indptr)
                    and same_bits(c.indices, mv.indices)
                    and same_bits(c.data, mv.data + 0)):
                raise AssertionError("phase 22: a CSR collective changed "
                                     "the matrix")
        if not (same_bits(psum, X) and same_bits(rsc, X)):
            raise AssertionError("phase 22: a dense collective changed X")
        errs["sparse_collectives"] = 0.0
        if not same_bits(outs["spmv_sharded_streamed"],
                         outs["spmv_sharded_blocked"]):
            raise AssertionError("phase 22: the streamed SpMV is not bitwise "
                                 "its blocked twin")
        bad = {k: v for k, v in errs.items() if not v <= RTOL}
        if bad:
            raise AssertionError(f"phase 22: past 1e-6 of the single-card "
                                 f"op: {bad}")
        seen = traced_kernels("phase 22's sparse SpGEMM and SpMV", lambda: (
            ops["spgemm_sharded_sparse(stream_b)"](),
            ops["spmv_sharded"]()), P22_TRACED, phase="phase 22")
        host, device = backend_calls(list(ops.values()), backend)
        cell = {"spmv_sharded": "16384^2/5e-3",
                "spmv_t_sharded": "16384^2/5e-3",
                "spmm_sharded": "10000^2/0.01 k=64",
                "spmv_sharded_streamed": "2^20/5e-7",
                "spmv_sharded_blocked": "2^20/5e-7",
                "sparse_collectives": "16384^2/5e-3, X 10000x64"}
        del outs
        for name, fn in ops.items():
            row = {"op": name, "cell": cell.get(name, "8192^2/1e-3"),
                   "world_size": 1, "backend": backend,
                   "ms": median_ms(fn, runs=P22_RUNS, warmup=1),
                   "busy_ms": device_profile(fn, calls=3)[0],
                   "peak_mb": peak_mb(fn), "rel_err": errs[name]}
            print(f"phase 22 [{smi}]: " + json.dumps(row), flush=True)
        print(f"phase 22 [{smi}]: one NCCL rank on cuda:0, NCCL "
              f"{torch.cuda.nccl.version()} (D = 1: no scaling to show; the "
              "rings make no hop at D = 1 and a self pair is a local copy, "
              f"so no P2P op runs); NCCL calls traced {host}, their device "
              f"events {device}; kernels traced {seen}; streamed SpMV "
              "bitwise blocked; sparse SpGEMM structure bitwise alg1's; "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        print(P22_MARK + json.dumps(launches), flush=True)
    finally:
        pp.destroy_process_group()
        tmp.cleanup()


def phase22_apart(smi):
    """Phase 22 in a process of its own (this script with `P22_FLAG`):
    NCCL's group and the profiler's traces start fresh there, as in a
    distributed program run from the command line.  Its output is this
    script's; returns its launch counts.  A non-zero exit raises."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           P22_FLAG], timeout=P22_TIMEOUT_S,
                          stdout=subprocess.PIPE, text=True)
    sys.stdout.write(done.stdout)
    if done.returncode:
        raise AssertionError(f"phase 22: its process exited "
                             f"{done.returncode}")
    line = next(ln for ln in done.stdout.splitlines()
                if ln.startswith(P22_MARK))
    print(f"phase 22 [{smi}]: its process took "
          f"{time.perf_counter() - t0:.1f} s, start included", flush=True)
    return json.loads(line[len(P22_MARK):])


def phase22_main():
    """The process of phase 22: the card checked, the kernels' library
    loaded (built by phase 0), then `phase22`."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    _build.library()
    phase22(torch.device("cuda", 0), card_line())


def main():
    smi = phase0()
    dev = torch.device("cuda", 0)
    cells = make_cells(dev)
    err = phase1(dev, cells)
    launches, nnzs = phase2(cells)
    rows = phase3(cells, nnzs, smi)
    del cells
    spmv_cells, spmm_cells = make_spmv_cells(dev)
    err4, _, checks, edges = phase4(dev, spmv_cells, spmm_cells)
    launches5 = phase5(spmv_cells, spmm_cells, edges, checks)
    del checks, edges
    rows6 = phase6(spmv_cells, spmm_cells, smi)
    # times of the SpMV/SpMM kernels at the streaming cells: SpMV
    # 16384^2/5e-3, SpMM 10000^2/0.01; segment_sum at the power-law matrix
    t_mv = rows6[1]
    t_pl = rows6[2]
    t_mm = next(r for r in rows6 if r["cell"] == spmm_cells[0][0])
    del spmv_cells, spmm_cells
    torch.cuda.empty_cache()
    launches7, err7, serving = phase7(dev)
    esc_cells = phase8(dev)
    rows9 = phase9(serving, esc_cells, smi)
    del serving, esc_cells
    torch.cuda.empty_cache()
    launches10, err10, engines, blocked_cells = phase10(dev)
    rows11 = phase11(blocked_cells, engines, smi)
    del blocked_cells
    torch.cuda.empty_cache()
    launches12, err12, bsr_cells, mxu_cells = phase12(dev)
    rows13 = phase13(bsr_cells, mxu_cells, smi)
    del bsr_cells, mxu_cells
    # the kernels line's times: bsr_spmm at the cell that fills the card,
    # csr_densify_mxu at 8192^2/1e-3 (256 MB out)
    t_bsr = next(r for r in rows13 if r["cell"] == BSR_CELLS[-1][0])
    t_mxu = next(r for r in rows13 if r["cell"] == MXU_CELLS[-1][0])
    torch.cuda.empty_cache()
    phase14(dev, smi)
    phase15(dev, smi)
    phase16(smi)
    torch.cuda.empty_cache()
    phase17(smi)
    phase18(dev, smi)
    phase19(dev, smi)
    torch.cuda.empty_cache()
    phase20(smi)
    torch.cuda.empty_cache()
    phase21_apart(smi)
    launches22 = phase22_apart(smi)
    t_sv = rows9[0]  # serving 1024^2/0.1
    t_pat = rows11[0]  # blocked 1024^2/0.1: the pattern of B
    head = rows[0]
    n1 = CELLS[0][1]  # 1024: the SpGEMM cell of rows 1-3
    mm_csr = 8 * t_mm["nnz"] + 4 * (t_mm["m"] + 1)
    spmv_bound = spmv_bound_ms(t_mv["nnz"], t_mv["m"], t_mv["n"])
    spmm_bound = bound(mm_csr + 4 * t_mm["k"] * (t_mm["n"] + t_mm["m"]),
                       2 * t_mm["nnz"] * t_mm["k"])
    sv_m, sv_k = t_sv["a_shape"]

    def kernel(name, source, replaces, launched, max_err, ms, plain_ms,
               least, library_ms):
        return {"name": name, "route": "cuda",
                "source": f"spmm_tpu_torch/csrc/{source}",
                "replaces": (replaces if replaces.startswith("none:")
                             else f"spmm_tpu/ops/kernels/{replaces}"),
                "launches": launched, "max_abs_err": max_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": least[0],
                "bound_by": least[1], "library_ms": library_ms}

    # bytes: each input read once, each output written once (dense outputs
    # whole, zeros included); sparse inputs as CSR (int32 indices, f32).
    # Launches: each main path's, phase 22's distributed path added
    l22 = launches22.get
    kernels = [
        kernel("densify_onehot", "densify.cu", "densify_onehot.py:309",
               launches["densify_onehot"] + l22("densify_onehot", 0),
               err["densify_onehot"],
               head["densify_ms"], head["densify_plain_ms"],
               bound(6 * n1 * n1 + 4 * (n1 + 1) + 8 * head["a_nnz"]),
               head["torch_to_dense_ms"]),
        kernel("densify_onehot_pattern", "densify.cu",
               "densify_onehot.py:250", launches10["densify_onehot_pattern"],
               err10, t_pat["pattern_ms"], t_pat["pattern_plain_ms"],
               bound(2 * n1 * n1 + 4 * (n1 + 1) + 4 * t_pat["pattern_nnz"]),
               t_pat["pattern_library_ms"]),
        # the kept values are read, the mask whole; torch has no call that
        # compacts under a mask keeping structural zeros
        kernel("extract_roll", "extract.cu", "extract_roll.py:123",
               launches["extract_roll"] + l22("extract_roll", 0),
               err["extract_roll"],
               head["extract_ms"], head["extract_plain_ms"],
               bound(n1 * n1 + 4 * (n1 + 1) + 12 * head["c_nnz"]), None),
        kernel("spmv_binned", "spmv_binned.cu", "spmv_binned.py:272",
               launches5["spmv_binned"], err4["spmv_binned"],
               t_mv["spmv_binned_ms"], t_mv["spmv_binned_plain_ms"],
               spmv_bound, t_mv["torch_csr_mv_ms"]),
        kernel("spmv_routed", "spmv_routed.cu", "spmv_routed.py:865",
               launches5["spmv_routed"], err4["spmv_routed"],
               t_mv["spmv_routed_ms"], t_mv["spmv_routed_plain_ms"],
               spmv_bound, t_mv["torch_csr_mv_ms"]),
        kernel("spmm_routed", "spmm_routed.cu", "spmv_routed.py:1054",
               launches5["spmm_routed"] + l22("spmm_routed", 0),
               err4["spmm_routed"],
               t_mm["spmm_routed_ms"], t_mm["spmm_routed_plain_ms"],
               spmm_bound, t_mm["torch_csr_mm_ms"]),
        kernel("spmv_onehot", "spmv_onehot.cu", "spmv_onehot.py:147",
               launches5["spmv_onehot"], err4["spmv_onehot"],
               t_mv["spmv_onehot_ms"], t_mv["spmv_onehot_plain_ms"],
               spmv_bound, t_mv["torch_csr_mv_ms"]),
        # the plan's int64 positions are an input: 8 bytes an entry
        kernel("expand_routed", "route.cu", "route.py:246",
               launches7["expand_routed"], err7["expand_routed"],
               t_sv["expand_routed_ms"], t_sv["expand_routed_plain_ms"],
               bound(4 * sv_m * sv_k + 12 * t_sv["a_nnz"]),
               t_sv["expand_library_ms"]),
        kernel("compress_routed", "route.cu", "route.py:318",
               launches7["compress_routed"], err7["compress_routed"],
               t_sv["compress_routed_ms"], t_sv["compress_routed_plain_ms"],
               compress_bound(t_sv), t_sv["compress_library_ms"]),
        # blocks, B and the (mb R, N) output once, the indices; 2 flops per
        # stored block element and column of B, three times over in TF32
        # (phase 13's bound_ms; its fp32_fma_bound_ms is the FMA units')
        kernel("bsr_spmm", "bsr_spmm.cu", "bsr_spmm.py:62",
               launches12["bsr_spmm"], err12["bsr_spmm"],
               t_bsr["bsr_spmm_ms"], t_bsr["bsr_spmm_plain_ms"],
               (t_bsr["bound_ms"], t_bsr["bound_by"]), t_bsr["library_ms"]),
        kernel("csr_densify_mxu", "densify_mxu.cu", "densify_mxu.py:89",
               launches12["csr_densify_mxu"], err12["csr_densify_mxu"],
               t_mxu["mxu_ms"], t_mxu["mxu_plain_ms"],
               bound(4 * t_mxu["m"] * t_mxu["k"] + 4 * (t_mxu["m"] + 1)
                     + 8 * t_mxu["nnz"]),
               t_mxu["mxu_library_ms"]),
        # the port's own kernels, no TPU kernel behind them.  The binned
        # plan: indptr once, rows and piece_end written once; no library
        # call computes it
        kernel("spmv_binned_plan", "spmv_binned.cu",
               "none: the port's own kernels (the TPU plan is host numpy, "
               "spmm_tpu/ops/kernels/spmv_binned.py:104)",
               launches5["spmv_binned_plan"], err4["spmv_binned_plan"],
               t_mv["spmv_binned_plan_ms"], t_mv["spmv_binned_plan_plain_ms"],
               bound(4 * (t_mv["m"] + 1) + 8 * t_mv["m"], t_mv["m"]), None),
        # the in-order segment sum (JAX: jax.ops.segment_sum / .at[].add):
        # values once, the int64 starts and lengths, the sums once; one add
        # an entry
        kernel("segment_sum", "segment_sum.cu",
               "none: the port's own kernel (JAX: jax.ops.segment_sum, "
               "spmm_tpu/ops/_primitives.py:151, and .at[].add, "
               "spmm_tpu/sparse/base.py:293)",
               launches5["segment_sum"] + l22("segment_sum", 0),
               err4["segment_sum"],
               t_pl["segment_sum_ms"], t_pl["segment_sum_plain_ms"],
               bound(4 * t_pl["nnz"] + 20 * t_pl["m"], t_pl["nnz"]),
               t_pl["segment_sum_library_ms"]),
    ]
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels not launched by their path: {missing}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == [P21_FLAG]:
        phase21_main()
    elif sys.argv[1:] == [P22_FLAG]:
        phase22_main()
    else:
        main()
