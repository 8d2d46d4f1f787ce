#!/usr/bin/env python3
"""Time the SpMV kernels, the serving gather and scatter, the pattern
densify, BSR SpMM, the alg3 count pass, alg1's extraction and densify and
the routed SpMM of one checkout of the PyTorch/CUDA port on one NVIDIA GPU
beside their PyTorch library calls, or of two checkouts in turns (A, B, B,
A), each turn in a process of its own.

    python3 tools/spmv_turns.py                     # this checkout
    python3 tools/spmv_turns.py --repo DIR          # the checkout at DIR
    python3 tools/spmv_turns.py --against DIR       # DIR, this, this, DIR
    python3 tools/spmv_turns.py --only pattern bsr  # some groups only

Groups (all by default): spmv, serving, pattern, bsr, count, expand,
extract, spmm, esc.

SpMV cells: 1024^2/0.1 (seed 2008), 16384^2/5e-3 (seed 2014) and the
power-law 2^20 matrix (`power_law_rows(2^20, 2^20, 16, alpha=1.5,
seed=0)`), x N(0,1) from seed 2024 in that order, as in chip_smoke.py;
timed: `spmv_binned`, `spmv_onehot`, `spmv_routed`, `spmv(a, x,
plan=("routed", p))`, `spmv(a, x)` and `torch.mv` of torch's CSR tensor.
Serving cells: `spgemm_plan` at SpGEMM 1024^2/0.1 (seeds 2008/2009) and
8192^2/1e-3 (seeds 2012/2013); timed: `compress_routed` (`extract_routed`
of the plan's dense product, and its accumulate form written in place) and
`torch.take` with int64 positions made once, outside the timing.
Pattern cells: `densify_onehot_pattern` of B at SpGEMM 1024^2/0.1 (seed
2009; the blocked engines' symbolic phase) and of B at 8192^2/1e-3 (seed
2013) at the (k, P n_b) shape of the cf 0.2 alg3 sizing pass, beside CSR
`to_dense()` of bf16 ones.  BSR cells: `bsr_spmm` at 4096^2/0.05, 4096^2/0.15,
8192^2/0.02 and 32768^2/0.02 (128x128 blocks of `block_sparse`, seeds
2016-2019, chip_smoke.py's cells) and at the CSR 8192^2/1e-3 (seed 2012)
re-tiled at (8, 128), X of 256 columns N(0,1) from seed 2024, beside
torch's BSR @ dense.  Count cells: the scan2 alg3 count pass (the sizing
pass, with its readback) at cf 0.2 and 0.05 at SpGEMM 1024^2/0.1,
1024^2/0.5 and 8192^2/1e-3, no library call.  Expand cells: the serving
densify `expand_routed` (`densify_routed` of A through its plan, value only
and with the pattern) at SpGEMM 1024^2/0.1 and 8192^2/1e-3 (seeds 2008 and
2012), beside CSR `to_dense()`.  Extract cells: alg1's compaction
`extract_roll` of the dense product under its mask at SpGEMM 1024^2/0.1,
1024^2/0.5 and 8192^2/1e-3 (the seeds above) with cap = nnz and cap = nnz
+ 4096 (and, where the checkout has `LARGE_MASK`, at each tile size),
beside `torch.masked_select` plus `nonzero` for context only (no one call
computes the whole function); in the same turns alg1's `densify_onehot` of
A and, at the 1024^2 cells, the whole `spgemm(a, b, alg=1)`.  SpMM cells:
`spmm_routed` at 10000^2/0.01 (seed 2015) and at the power-law 2^20 matrix
(`power_law_rows(2^20, 2^20, 16, alpha=1.5, seed=0)`), X of 64 columns
N(0,1) from seed 2024, over the serving plan and over the per-call one
(`sell=False`), beside torch's CSR @ dense, with each cell's bytes-once
bound and the bytes its gathers of X move (`gathered_bytes`: 4 k an entry);
a probe of the card's gather rate: the same kernel at 10000^2/0.01 with
every column id taken modulo 256 (an X of 64 KB that stays in L1) beside
the cell itself (a random X of 2.56 MB, served by L2), each as gathered
bytes over device time; and probes that split the power-law call
(`powerlaw_probes`): its rows up to the cut alone, its longer rows alone,
one full row of 2^20 entries, and the chunks in row order or with the rows
of 1024 chunks or more first.  ESC cells: SpGEMM 1024^2/0.1 and
8192^2/1e-3 (the seeds above): the whole `spgemm(a, b, alg=2, impl="esc")`,
and on its sorted products the run count and the compress (`_compress`,
alpha 1.5) alone, each with its bytes-once bound (8 bytes a product to
count; 12 a product, 8 an output entry and 4 a row to compress).

Per call: `call_ms`, the median CUDA-event time around one call (the host's
wrapper included), taken in turns within the process (library, kernels,
kernels, library: `call_ms` holds both turns); `loop_ms`, events around
200 back-to-back calls over the count; `busy_ms`, the device time per call
in a torch.profiler trace (None where the trace holds no device events);
and, for `spmv_routed` and `compress_routed`, the trace's kernels by name
(`top`).  `bound_ms` is the least time of the work at 3.35 TB/s: for SpMV
8 bytes an entry, indptr, x and y once; for the gather the positions
(4 or 8 bytes an entry), the output, and `c` counted in the 32-byte
sectors its entries touch; for the pattern its 2 bytes a dense cell, indptr
and indices; for the serving densify its 4 bytes a dense cell (6 with the
pattern) and 12 an entry; for the extraction the mask's byte a cell, 4 an
indptr entry and 12 a kept cell; for SpMM the CSR, X and the output once;
for BSR SpMM the larger of its bytes and its 3 * 2 *
nblocks*R*C*N TF32 operations at 494.7 TFLOP/s.  Each turn prints one JSON line with the card's
name and power limit.

Every turn also prints, under `bits`, a SHA-256 of each output the groups
`expand`, `pattern`, `extract` and `spmm` produce (the serving densify and
the pattern at their cells, alg1's `densify_onehot` at its cells, and
`spmm_routed` at both SpMM cells and at edges: k = 1, 33, 45, 64, 128, an X
off 16-byte alignment, rows closed by up to 563 chunks, empty and one-row
matrices).  With `--against`, a last line says for each output whether its
bits are the same in every turn of both checkouts.  Needs a CUDA device;
imports neither jax nor spmm_tpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 494.7e12
GROUPS = ("spmv", "serving", "pattern", "bsr", "count", "expand", "extract",
          "spmm", "esc")


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
    """(device ms per call, [[kernel name, ms per call], ...] largest
    first) of `fn` in a profiler trace; (None, []) without device events."""
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
            ms = e.time_range.elapsed_us() / calls / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    if not by_name:
        return None, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), [[k[:60], v] for k, v in top]


def in_turns(torch, calls: dict, library, detail=()) -> dict:
    """Each call's times; `call_ms` in turns (library, the others, the
    others again, library; no library: the others twice), then the 200-call
    loop and the trace."""
    others = [k for k in calls if k != library]
    row = {k: {"call_ms": []} for k in calls}
    ends = [library] if library else []
    for key in [*ends, *others, *others, *ends]:
        row[key]["call_ms"].append(median_ms(torch, calls[key]))
    for key, fn in calls.items():
        row[key]["loop_ms"] = loop_ms(torch, fn)
        busy, top = busy_ms(torch, fn)
        row[key]["busy_ms"] = busy
        if key in detail:
            row[key]["top"] = top
    return row


def digest(torch, t) -> str:
    """SHA-256 of a tensor's bytes (bfloat16 through its int16 view)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:32]


def spmv_cells(torch, pt, power_law_rows, dev):
    import numpy as np

    rng = np.random.default_rng(2024)
    mats = [("spmv 1024^2/0.1",
             pt.random(1024, 1024, 0.1, format="csr", seed=2008, device=dev)),
            ("spmv 16384^2/5e-3",
             pt.random(16384, 16384, 5e-3, format="csr", seed=2014,
                       device=dev)),
            ("spmv powerlaw 2^20",
             power_law_rows(1 << 20, 1 << 20, 16, alpha=1.5, seed=0,
                            device=dev))]
    return [(name, a, torch.from_numpy(rng.standard_normal(
        a.shape[1]).astype(np.float32)).to(dev)) for name, a in mats]


def torch_sparse(torch, layout, *arrays, shape):
    """torch's own sparse CSR or BSR tensor of the same arrays (int64
    indices): the library calls' operand."""
    make = {"csr": torch.sparse_csr_tensor, "bsr": torch.sparse_bsr_tensor}
    indptr, indices, values = arrays
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # beta notices
        return make[layout](indptr.long(), indices.long(), values, shape)


def measure(repo: str, groups) -> dict:
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    import spmm_tpu_torch as pt
    from spmm_tpu_torch.models import power_law_rows
    from spmm_tpu_torch.ops.kernels import route
    from spmm_tpu_torch.ops.kernels import spmv_binned as kb
    from spmm_tpu_torch.ops.kernels import spmv_onehot as ko
    from spmm_tpu_torch.ops.kernels import spmv_routed as kr

    if not torch.cuda.is_available():
        raise SystemExit("spmv_turns: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    out = {"repo": os.path.abspath(pt.__file__), "card": smi, "bits": {}}
    if "spmv" in groups:
        spmv_turns(torch, pt, power_law_rows, kb, ko, kr, dev, out)
    if "serving" in groups:
        serving_turns(torch, np, pt, route, dev, out)
    if "pattern" in groups:
        pattern_turns(torch, pt, dev, out)
    if "bsr" in groups:
        bsr_turns(torch, np, pt, dev, out)
    if "count" in groups:
        count_turns(torch, pt, dev, out)
    if "expand" in groups:
        expand_turns(torch, pt, route, dev, out)
    if "extract" in groups:
        extract_turns(torch, pt, dev, out)
    if "spmm" in groups:
        spmm_turns(torch, np, pt, power_law_rows, kr, dev, out)
    if "esc" in groups:
        esc_turns(torch, pt, dev, out)
    return out


def spmv_turns(torch, pt, power_law_rows, kb, ko, kr, dev, out):
    for name, a, x in spmv_cells(torch, pt, power_law_rows, dev):
        m, n = a.shape
        args = (a.indptr, a.indices, a.data)
        binned = kb.spmv_binned_plan(*args, m, n)
        onehot = ko.spmv_onehot_plan(a.indptr, m, n)
        routed = kr.spmv_routed_plan(*args, m, n)
        ta = torch_sparse(torch, "csr", *args, shape=a.shape)
        calls = {"torch_mv": lambda: torch.mv(ta, x),
                 "spmv_binned": lambda: kb.spmv_binned(x, binned),
                 "spmv_onehot": lambda: ko.spmv_onehot(*args, x, m, n,
                                                       onehot),
                 "spmv_routed": lambda: kr.spmv_routed(x, routed),
                 "spmv_tag_routed": lambda: pt.spmv(
                     a, x, plan=("routed", routed)),
                 "spmv_call": lambda: pt.spmv(a, x)}
        row = {"nnz": a.nnz, "bound_ms": (8 * a.nnz + 4 * (m + 1) + 4 * n
                                          + 4 * m) / HBM_BYTES_S * 1e3}
        row.update(in_turns(torch, calls, "torch_mv", ("spmv_routed",)))
        out[name] = row
        del ta, binned, onehot, routed


def serving_turns(torch, np, pt, route, dev, out):
    rng = np.random.default_rng(2025)
    for name, nn, d, sa, sb in (("1024^2/0.1", 1024, 0.1, 2008, 2009),
                                ("8192^2/1e-3", 8192, 1e-3, 2012, 2013)):
        a = pt.random(nn, nn, d, format="csr", seed=sa, device=dev)
        b = pt.random(nn, nn, d, format="csr", seed=sb, device=dev)
        plan = pt.spgemm_plan(a, b)
        pc = plan._pc
        c = plan._product(a.data, b.data)
        pos64 = pc.pos.long()
        prev = torch.from_numpy(rng.standard_normal(pc.cap).astype(
            np.float32)).to(dev)
        sectors = int(torch.unique(pos64 // 8).numel())
        nbytes = (pc.pos.element_size() + 4) * pc.cap + 32 * sectors
        calls = {"torch_take": lambda: torch.take(c, pos64),
                 "compress_routed": lambda: route.extract_routed(c, pc),
                 "compress_routed_acc": lambda: route.extract_routed(
                     c, pc, 0.5, c_prev=prev, beta=1.0, out=prev)}
        row = {"cap": pc.cap, "pos_bytes": pc.pos.element_size(),
               "c_sectors": sectors,
               "bound_ms": nbytes / HBM_BYTES_S * 1e3,
               "bound_12B_ms": 12 * pc.cap / HBM_BYTES_S * 1e3}
        row.update(in_turns(torch, calls, "torch_take", ("compress_routed",)))
        out[f"serving {name}"] = row
        del plan, pc, c, pos64, prev


def pattern_turns(torch, pt, dev, out):
    from spmm_tpu_torch.ops import spgemm_blocked as bl
    from spmm_tpu_torch.ops.kernels.densify_onehot import (
        densify_onehot_pattern)

    for name, nn, d, seed, cf in (("1024^2/0.1 B", 1024, 0.1, 2009, None),
                                  ("8192^2/1e-3 B, cf 0.2 sizing", 8192,
                                   1e-3, 2013, 0.2)):
        b = pt.random(nn, nn, d, format="csr", seed=seed, device=dev)
        n_b, P = bl._alg3_grid(nn, nn, cf)[:2] if cf else (nn, 1)
        n = P * n_b
        ones = torch.ones(b.nnz, dtype=torch.bfloat16, device=dev)
        tb = torch_sparse(torch, "csr", b.indptr, b.indices, ones,
                          shape=(nn, n))
        calls = {"to_dense": tb.to_dense,
                 "densify_onehot_pattern": lambda: densify_onehot_pattern(
                     b.indptr, b.indices, nn, n)}
        row = {"shape": [nn, n], "nnz": b.nnz,
               "bound_ms": (2 * nn * n + 4 * (nn + 1) + 4 * b.nnz)
               / HBM_BYTES_S * 1e3}
        row.update(in_turns(torch, calls, "to_dense",
                            ("densify_onehot_pattern",)))
        out[f"pattern {name}"] = row
        out["bits"][f"pattern {name}"] = digest(
            torch, calls["densify_onehot_pattern"]())
        del b, ones, tb


def bsr_turns(torch, np, pt, dev, out):
    from spmm_tpu_torch.models import block_sparse
    from spmm_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm

    rng = np.random.default_rng(2024)
    cells = [(f"{n}^2/{d} (128, 128)", lambda n=n, d=d, seed=seed:
              block_sparse(n, n, (128, 128), d, seed=seed,
                           device=dev).tobsr((128, 128)))
             for n, d, seed in ((4096, 0.05, 2016), (4096, 0.15, 2017),
                                (8192, 0.02, 2018), (32768, 0.02, 2019))]
    for name, make in (
            *cells,
            ("csr 8192^2/1e-3 -> (8, 128)", lambda: pt.random(
                8192, 8192, 1e-3, format="csr", seed=2012,
                device=dev).tobsr((8, 128)))):
        ab = make()
        m, k = ab.shape
        R, C = ab.blocksize
        x = torch.from_numpy(rng.standard_normal((k, 256)).astype(
            np.float32)).to(dev)
        tb = torch_sparse(torch, "bsr", ab.indptr, ab.indices, ab.data,
                          shape=(m, k))
        calls = {"torch_bsr_mm": lambda: tb @ x,
                 "bsr_spmm": lambda: bsr_spmm(ab.indptr, ab.indices,
                                              ab.data, x, m)}
        mb = ab.indptr.numel() - 1
        nbytes = 4 * (ab.nblocks * R * C + k * 256 + mb * R * 256 + mb + 1
                      + ab.nblocks)
        flops = 2 * ab.nblocks * R * C * 256
        row = {"nblocks": ab.nblocks, "blocksize": [R, C],
               "bound_ms": max(nbytes / HBM_BYTES_S,
                               3 * flops / TF32_FLOPS) * 1e3}
        library = "torch_bsr_mm"
        try:
            calls[library]()
        except (RuntimeError, NotImplementedError) as e:
            row["library_error"], library = str(e)[:120], None
            del calls["torch_bsr_mm"]
        row.update(in_turns(torch, calls, library, ("bsr_spmm",)))
        out[f"bsr {name}"] = row
        del ab, x, tb


def count_turns(torch, pt, dev, out):
    from spmm_tpu_torch.ops import spgemm_blocked as bl

    for name, nn, d, sa, sb in (("1024^2/0.1", 1024, 0.1, 2008, 2009),
                                ("1024^2/0.5", 1024, 0.5, 2010, 2011),
                                ("8192^2/1e-3", 8192, 1e-3, 2012, 2013)):
        a = pt.random(nn, nn, d, format="csr", seed=sa, device=dev)
        b = pt.random(nn, nn, d, format="csr", seed=sb, device=dev)
        host = [t.cpu().numpy() for t in (a.indptr, a.indices, b.indptr,
                                          b.indices)]
        calls = {}
        for cf in (0.2, 0.05):
            n_b, P, _, m_pad, T = bl._alg3_grid(nn, nn, cf)
            blocks = bl._Blocks(a, b, host, n_b, P, m_pad)

            def count(blocks=blocks, n_b=n_b, T=T, P=P):
                _, blockc = bl._alg3_count_fast(blocks, b.indptr, b.indices,
                                                n_b, T, P)
                return blockc.contiguous().cpu()

            calls[f"alg3_cf{cf}_count"] = count
        out[f"count {name}"] = in_turns(torch, calls, None)
        del a, b, calls


def expand_turns(torch, pt, route, dev, out):
    for name, nn, d, seed in (("1024^2/0.1", 1024, 0.1, 2008),
                              ("8192^2/1e-3", 8192, 1e-3, 2012)):
        a = pt.random(nn, nn, d, format="csr", seed=seed, device=dev)
        plan = route.expand_route_plan(a.indptr, a.indices, nn, nn, dev)
        ta = torch_sparse(torch, "csr", a.indptr, a.indices, a.data,
                          shape=a.shape)
        calls = {"to_dense": ta.to_dense,
                 "expand_routed": lambda: route.densify_routed(
                     a.data, plan, emit_pattern=False),
                 "expand_routed_pattern": lambda: route.densify_routed(
                     a.data, plan)}
        row = {"nnz": a.nnz,
               "bound_ms": (4 * nn * nn + 12 * a.nnz) / HBM_BYTES_S * 1e3,
               "bound_pattern_ms": (6 * nn * nn + 12 * a.nnz)
               / HBM_BYTES_S * 1e3}
        row.update(in_turns(torch, calls, "to_dense",
                            ("expand_routed", "expand_routed_pattern")))
        out[f"expand {name}"] = row
        val, pat = calls["expand_routed_pattern"]()
        for what, t in (("values", val), ("pattern", pat),
                        ("value only", calls["expand_routed"]())):
            out["bits"][f"expand {name} {what}"] = digest(torch, t)
        del a, plan, ta


def extract_turns(torch, pt, dev, out):
    import importlib

    from spmm_tpu_torch.ops.kernels import extract_roll as er
    from spmm_tpu_torch.ops.kernels.densify_onehot import densify_onehot

    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    for name, nn, d, sa, sb in (("1024^2/0.1", 1024, 0.1, 2008, 2009),
                                ("1024^2/0.5", 1024, 0.5, 2010, 2011),
                                ("8192^2/1e-3", 8192, 1e-3, 2012, 2013)):
        a = pt.random(nn, nn, d, format="csr", seed=sa, device=dev)
        b = pt.random(nn, nn, d, format="csr", seed=sb, device=dev)
        c, mask, nnz = sg._alg1_dense_compute(a, b, 1.0)
        nnz = int(nnz)

        calls = {"masked_select_nonzero": lambda: (
                     torch.masked_select(c, mask), mask.nonzero()),
                 "extract_roll": lambda: er.extract_roll(c, mask, nnz),
                 "extract_roll_pad4096": lambda: er.extract_roll(
                     c, mask, nnz + 4096),
                 "densify_onehot": lambda: densify_onehot(
                     a.indptr, a.indices, a.data, nn, nn)}
        if hasattr(er, "LARGE_MASK"):  # each tile size
            def at_tiles(large):
                keep, er.LARGE_MASK = er.LARGE_MASK, 0 if large else 2**31
                try:
                    return er.extract_roll(c, mask, nnz)
                finally:
                    er.LARGE_MASK = keep

            for tile, large in zip(er.TILE_CELLS, (False, True)):
                calls[f"extract_roll_tile{tile}"] = (
                    lambda large=large: at_tiles(large))
        if nn == 1024:
            calls["spgemm_alg1"] = lambda: pt.spgemm(a, b, alg=1)
        row = {"nnz": nnz, "a_nnz": a.nnz,
               "bound_ms": (nn * nn + 4 * (nn + 1) + 12 * nnz)
               / HBM_BYTES_S * 1e3,
               "densify_bound_ms": (6 * nn * nn + 4 * (nn + 1) + 8 * a.nnz)
               / HBM_BYTES_S * 1e3}
        row.update(in_turns(torch, calls, "masked_select_nonzero",
                            ("extract_roll", "densify_onehot")))
        out[f"extract {name}"] = row
        val, pat = calls["densify_onehot"]()
        value_only, _ = densify_onehot(a.indptr, a.indices, a.data, nn, nn,
                                       with_pattern=False)
        for what, t in (("values", val), ("pattern", pat),
                        ("value only", value_only)):
            out["bits"][f"densify_onehot {name} {what}"] = digest(torch, t)
        del a, b, c, mask, calls


def spmm_edges(np, dev, torch):
    """(name, indptr, indices, data, m, n, plan keywords) of the SpMM edges:
    an empty row, a full row of 9000 entries in 563 chunks of 16 and an
    empty row; rows spanning many chunks between empty ones; one row of
    4999 entries; an all-empty matrix; a 300x200 matrix at 0.05."""
    rng = np.random.default_rng(11)

    def csr(lens, n):
        lens = np.asarray(lens, np.int64)
        indices = np.concatenate(
            [np.sort(rng.choice(n, int(k), replace=False)) for k in lens]
            + [np.zeros(0, np.int64)])
        indptr = np.concatenate([[0], np.cumsum(lens)])
        data = rng.standard_normal(indices.size).astype(np.float32)
        data[:3] = 0.0
        return [torch.from_numpy(a).to(dev) for a in (
            indptr.astype(np.int32), indices.astype(np.int32), data)]

    span = np.zeros(60, np.int64)
    span[[5, 6, 30, 40]] = [2900, 1, 2000, 256]
    span[10:25] = rng.integers(0, 40, 15)
    uniform = rng.binomial(200, 0.05, 300)
    return [("full row 3x9000", csr([0, 9000, 0], 9000), 3, 9000),
            ("span chunks 60x3000", csr(span, 3000), 60, 3000),
            ("m=1 1x5000", csr([4999], 5000), 1, 5000),
            ("all empty 50x40", csr(np.zeros(50), 40), 50, 40),
            ("uniform 300x200", csr(uniform, 200), 300, 200)]


def misaligned(torch, x):
    """A contiguous copy of x starting 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def powerlaw_probes(torch, pt, kr, a, x, routed) -> dict:
    """Calls that split the power-law SpMM's time: the same kernel over the
    rows up to the plan's cut alone and over the longer rows alone (each
    with the other rows emptied), over one full row of 2^20 entries (2048
    chunks closed by one group), and, where the plan orders its chunks, with
    the chunks in row order instead."""
    m, n = a.shape
    lens = a.indptr[1:] - a.indptr[:-1]
    rows = torch.repeat_interleave(torch.arange(m, device=a.data.device),
                                   lens.long(), output_size=a.nnz)
    calls = {}
    for key, keep in (("short_rows_only", lens <= routed.cut),
                      ("long_rows_only", lens > routed.cut)):
        part = pt.CSR.from_parts(
            torch.cat([lens.new_zeros(1),
                       torch.cumsum(lens * keep, 0, dtype=torch.int32)]),
            a.indices[keep[rows]], a.data[keep[rows]], (m, n),
            canonical=True)
        plan = kr.spmv_routed_plan(part.indptr, part.indices, part.data, m, n)
        calls[f"spmm_routed_{key}"] = (
            lambda plan=plan: kr.spmm_routed(x, plan))
    full = torch.tensor([0, 0, n, n], dtype=torch.int32, device=x.device)
    one = kr.spmv_routed_plan(full, torch.arange(n, dtype=torch.int32,
                                                 device=x.device),
                              a.data[:n].contiguous(), 3, n)
    calls["spmm_routed_one_full_row"] = lambda: kr.spmm_routed(x, one)
    if hasattr(routed, "chunk_order"):
        by_row = routed._replace(chunk_order=torch.arange(
            routed.chunk_order.numel(), dtype=torch.int32, device=x.device))
        calls["spmm_routed_chunks_in_row_order"] = (
            lambda: kr.spmm_routed(x, by_row))
        # the rows of 1024 chunks or more first (each set by first column),
        # so that their closing sums overlap the other chunks' work
        nch = (routed.long_chunk_ptr[1:]
               - routed.long_chunk_ptr[:-1])[routed.chunk_row.long()]
        first = routed.indices[routed.chunk_start.long()].long()
        key = (nch < 1024).long() * n + first
        big_first = routed._replace(chunk_order=torch.sort(
            key, stable=True).indices.to(torch.int32))
        calls["spmm_routed_big_rows_first"] = (
            lambda: kr.spmm_routed(x, big_first))
    return calls


def spmm_turns(torch, np, pt, power_law_rows, kr, dev, out):
    rng = np.random.default_rng(2024)
    cells = [("spmm 10000^2/0.01 k=64",
              pt.random(10000, 10000, 0.01, format="csr", seed=2015,
                        device=dev)),
             ("spmm powerlaw 2^20 k=64",
              power_law_rows(1 << 20, 1 << 20, 16, alpha=1.5, seed=0,
                             device=dev))]
    for name, a in cells:
        m, n = a.shape
        x = torch.from_numpy(rng.standard_normal((n, 64)).astype(
            np.float32)).to(dev)
        args = (a.indptr, a.indices, a.data)
        routed = kr.spmv_routed_plan(*args, m, n)
        percall = kr.spmv_routed_plan(*args, m, n, sell=False)
        ta = torch_sparse(torch, "csr", *args, shape=a.shape)
        calls = {"torch_csr_mm": lambda: ta @ x,
                 "spmm_routed": lambda: kr.spmm_routed(x, routed),
                 "spmm_routed_percall_plan": lambda: kr.spmm_routed(
                     x, percall)}
        nbytes = 8 * a.nnz + 4 * (m + 1) + 4 * 64 * (n + m)
        row = {"nnz": a.nnz, "k": 64, "long_rows": routed.long_rows.numel(),
               "chunks": routed.chunk_start.numel(),
               "bound_ms": max(nbytes / HBM_BYTES_S,
                               2 * a.nnz * 64 / 67e12) * 1e3,
               "gathered_bytes": 4 * 64 * a.nnz}
        if name.startswith("spmm 10000"):
            # the gather-rate probe: column ids modulo 256, so the gathers
            # hit an X of 64 KB that stays in L1
            small = kr.spmv_routed_plan(a.indptr, a.indices % 256, a.data,
                                        m, 256)
            xs = x[:256].contiguous()
            calls["spmm_routed_l1_probe"] = lambda: kr.spmm_routed(xs, small)
        else:
            calls.update(powerlaw_probes(torch, pt, kr, a, x, routed))
        row.update(in_turns(torch, calls, "torch_csr_mm", ("spmm_routed",)))
        for key in ("spmm_routed", "spmm_routed_l1_probe"):
            busy = row.get(key, {}).get("busy_ms")
            if busy:
                row[key]["gather_tb_s"] = row["gathered_bytes"] / busy / 1e9
        out[name] = row
        for what, plan in (("serving plan", routed), ("per-call plan",
                                                      percall)):
            out["bits"][f"{name} {what}"] = digest(
                torch, kr.spmm_routed(x, plan))
        del ta, routed, percall, calls
        torch.cuda.empty_cache()
    for name, (indptr, indices, data), m, n in spmm_edges(np, dev, torch):
        for k in (1, 33, 45, 64, 128):
            x = torch.from_numpy(rng.standard_normal((n, k)).astype(
                np.float32)).to(dev)
            for layout, xx in (("aligned", x), ("misaligned",
                                                misaligned(torch, x))):
                for kw in ({}, {"cut": 8, "ch": 16}):
                    for sell in (True, False):
                        p = kr.spmv_routed_plan(indptr, indices, data, m, n,
                                                sell=sell, **kw)
                        key = (f"spmm edge {name} k={k} {layout} "
                               f"{'cut=8 ch=16 ' if kw else ''}sell={sell}")
                        out["bits"][key] = digest(torch,
                                                  kr.spmm_routed(xx, p))


def esc_turns(torch, pt, dev, out):
    import importlib

    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    # the run count of ESC's front half: the kernel where the checkout has
    # it, the torch ops before
    count = getattr(sg, "count_runs", sg.prim.count_unique_sorted)
    for name, nn, d, sa, sb in (("1024^2/0.1", 1024, 0.1, 2008, 2009),
                                ("8192^2/1e-3", 8192, 1e-3, 2012, 2013)):
        a = pt.random(nn, nn, d, format="csr", seed=sa, device=dev)
        b = pt.random(nn, nn, d, format="csr", seed=sb, device=dev)
        counts, ends, P = sg._esc_work(a, b)
        row_s, col_s, val_s, nnz = sg._esc_expand_sort_count(
            a.rows, a.indices, a.data, b.indptr, b.indices, b.data, counts,
            ends, P, nn, nn)
        nnz = int(nnz)
        calls = {"spgemm_esc": lambda: pt.spgemm(a, b, alg=2, impl="esc"),
                 "esc_count": lambda: count(row_s, col_s),
                 "esc_compress": lambda: sg._compress(row_s, col_s, val_s,
                                                      1.5, nnz, nn)}
        row = {"products": P, "nnz": nnz,
               "bound_count_ms": 8 * P / HBM_BYTES_S * 1e3,
               "bound_compress_ms": (12 * P + 8 * nnz + 4 * (nn + 1))
               / HBM_BYTES_S * 1e3}
        row.update(in_turns(torch, calls, None, tuple(calls)))
        out[f"esc {name}"] = row
        c = calls["spgemm_esc"]()
        for what, t in zip(("indptr", "indices", "data"),
                           (c.indptr, c.indices, c.data)):
            out["bits"][f"esc {name} spgemm {what}"] = digest(torch, t)
        for what, t in zip(("indptr", "col", "val"), calls["esc_compress"]()):
            out["bits"][f"esc {name} compress {what}"] = digest(torch, t)
        del a, b, counts, ends, row_s, col_s, val_s, calls, c


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--against", default=None)
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    args = ap.parse_args()
    if args.against is None:
        print(json.dumps(measure(os.path.abspath(args.repo), args.only)),
              flush=True)
        return
    other = os.path.abspath(args.against)
    bits = []
    for repo in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--repo", repo, "--only", *args.only],
                              check=True, stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        bits.append(json.loads(proc.stdout.strip().splitlines()[-1])["bits"])
    same = {key: all(b.get(key) == bits[0][key] for b in bits)
            for key in bits[0]}
    print(json.dumps({"bitwise_in_every_turn": same,
                      "all_same": all(same.values())}), flush=True)


if __name__ == "__main__":
    main()
