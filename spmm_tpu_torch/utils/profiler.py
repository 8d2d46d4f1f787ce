"""Benchmark and profiling harness of the port.

Port of `spmm_tpu/utils/profiler.py`, the reference's measurement stack
(SURVEY.md §2.1/§5):

  * `benchmark(fn, args, n_repeat, n_warmup)`, the `cupyx.profiler.benchmark`
    analogue: on the card one CUDA-event pair around each call, recorded
    after a synchronize, so a sample is the call's time on the stream with
    its host wrapper; on the CPU `time.perf_counter` around each call;
  * `profile_op(name, fn)`, the `profile_op_gpu` analogue
    (SpGEMM_alg_comparison/profiler.py:108-143): one timed call with
    ΔPeak = `max_memory_allocated` after it (the peak reset by
    `reset_peak_memory_stats` before it) − `memory_allocated` before it:
    workspace, output and transients of the call;
  * `repeat_op(...)`: warm-up and N `profile_op` runs, an out-of-memory
    error skipped with `[SKIP]` (dense_vs_sparseGEMM/utils.py:144-197);
  * `BenchResult`, the result row (dense_vs_sparseGEMM/utils.py:35);
  * `trace(path)`: a `torch.profiler` context that writes a Chrome trace;
    `device_busy_ms(fn)`: the device's busy time per call, from such a
    trace;
  * `span(name)`: the port's own spans.  The SpGEMM entry, its engines,
    the host structural product, the serving plan's build and call, and
    every device-to-host read (`_primitives.read_host`, one `sync.<what>`
    span each) open one.  While a `torch.profiler` runs, a span is a host
    event of that name in the profiler's trace, on the clock of the
    device's events, so `trace(path)` shows the port's layers and its
    host syncs in the Chrome trace; it also adds to in-memory totals per
    name: count, total and self nanoseconds (the duration less the time
    its child spans cover, one stack per thread) and the number of root
    spans, those opened while no span of the port is open (one public
    call each).  `span_totals()` returns a copy, `reset_spans()` clears
    them.  While no profiler runs, `span` returns one shared no-op
    context: one check of the profiler's own on/off flag, no allocation
    and no clock read, 0.2-0.4 us a span on an H100 machine's host
    (`python3 -m tools.span_cost`), so the sub-millisecond calls carry
    their spans unseen.  No setting turns them on but the profiler.

Every function measures on the card unless it is given `device="cpu"`;
without a card it raises and never falls back to the CPU.  Memory figures
exist only on the card (None on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler

try:  # a host event without record_function's Python overhead
    from torch._C._profiler import _RecordFunctionFast as _HostEvent
except ImportError:
    _HostEvent = torch.profiler.record_function


@dataclasses.dataclass
class BenchResult:
    name: str
    time_ms: float
    times_ms: Sequence[float] = dataclasses.field(default_factory=list)
    peak_hbm_bytes: Optional[int] = None
    delta_hbm_bytes: Optional[int] = None
    out_shape: Optional[tuple] = None
    dtype: Optional[str] = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def median_ms(self) -> float:
        return statistics.median(self.times_ms) if self.times_ms else self.time_ms

    @property
    def min_ms(self) -> float:
        return min(self.times_ms) if self.times_ms else self.time_ms

    def row(self) -> str:
        peak = (f"{self.delta_hbm_bytes / 2**20:9.1f} MB"
                if self.delta_hbm_bytes is not None else "      n/a")
        return (f"{self.name:<32s} {self.median_ms:10.4f} ms  ΔHBM {peak}  "
                f"out={self.out_shape} {self.dtype or ''}")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["median_ms"] = self.median_ms
        d["times_ms"] = list(map(float, self.times_ms))
        return json.dumps(d)


def measuring_device(device=None) -> torch.device:
    """The device a measurement runs on: the card unless `device` says
    otherwise; raises where the card is asked for and there is none."""
    from spmm_tpu_torch.sparse.base import resolve_device

    return resolve_device(device)


def card_info() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (its
    first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _out_meta(out):
    shape = getattr(out, "shape", None)
    dtype = str(getattr(out, "dtype", "")) or None
    return (tuple(shape) if shape is not None else None), dtype


def _timed_call(fn: Callable, args: tuple, on_card: bool):
    """(output, ms) of one call: a CUDA-event pair around it on the card,
    recorded after a synchronize; the host clock on the CPU."""
    if not on_card:
        t0 = time.perf_counter()
        out = fn(*args)
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_memory_stats(device=None) -> dict:
    """`torch.cuda.memory_stats` of the card; {} on the CPU."""
    device = measuring_device(device)
    if device.type != "cuda":
        return {}
    return torch.cuda.memory_stats(device)


def benchmark(fn: Callable, args: tuple = (), n_repeat: int = 10,
              n_warmup: int = 2, name: Optional[str] = None,
              device=None) -> BenchResult:
    """Time `fn(*args)` after `n_warmup` calls: one sample per call (the
    `cupyx.profiler.benchmark(func, args, n_repeat, n_warmup)` analogue)."""
    on_card = measuring_device(device).type == "cuda"
    for _ in range(n_warmup):
        fn(*args)
    times = []
    out = None
    for _ in range(n_repeat):
        out, ms = _timed_call(fn, args, on_card)
        times.append(ms)
    shape, dtype = _out_meta(out)
    return BenchResult(name=name or getattr(fn, "__name__", "op"),
                       time_ms=statistics.median(times), times_ms=times,
                       out_shape=shape, dtype=dtype)


def profile_op(name: str, fn: Callable, device=None) -> BenchResult:
    """One timed call of `fn()` with its ΔPeak (module docstring); the
    memory fields are None on the CPU."""
    device = measuring_device(device)
    on_card = device.type == "cuda"
    gc.collect()
    base = None
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    out, ms = _timed_call(fn, (), on_card)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    delta = peak - base if on_card else None
    shape, dtype = _out_meta(out)
    del out
    return BenchResult(name=name, time_ms=ms, times_ms=[ms],
                       peak_hbm_bytes=peak, delta_hbm_bytes=delta,
                       out_shape=shape, dtype=dtype)


def repeat_op(name: str, fn: Callable, runs: int = 10, warmup: int = 2,
              device=None, oom_ok: bool = True) -> Optional[BenchResult]:
    """Warm-up and `runs` `profile_op` calls, the median as `time_ms`.  An
    out-of-memory error (`torch.OutOfMemoryError` on the card,
    `MemoryError` on the host) prints `[SKIP]` and returns None where
    `oom_ok`; every other error is raised."""
    try:
        for _ in range(warmup):
            fn()
        times = []
        last = None
        for _ in range(runs):
            last = profile_op(name, fn, device=device)
            times.append(last.time_ms)
        if last is None:
            raise ValueError("repeat_op: runs must be at least 1")
        last.times_ms = times
        last.time_ms = statistics.median(times)
        return last
    except (torch.OutOfMemoryError, MemoryError) as e:
        if not oom_ok:
            raise
        print(f"[SKIP] {name}: {type(e).__name__}: {str(e)[:200]}")
        cleanup_device()
        return None


def cleanup_device():
    """Free what can be freed between sweep configurations (the
    `cleanup_gpu` analogue, dense_vs_sparseGEMM/utils.py:17-28)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class trace:
    """Context manager around `torch.profiler` that writes a Chrome trace
    (the `cupy.cuda.profiler` start/stop analogue,
    SpGEMM_alg_comparison/profiler.py:21):

        with profiler.trace("trace.json"):
            run_op()

    Open the file in chrome://tracing or Perfetto.  The default path is
    `spmm_tpu_torch_trace.json` in the temporary directory."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.path.join(tempfile.gettempdir(),
                                         "spmm_tpu_torch_trace.json")
        self.prof = None

    def __enter__(self):
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.prof.export_chrome_trace(self.path)
        return False


_OFF = contextlib.nullcontext()
_TOTALS = ("count", "total_ns", "self_ns", "roots")
_SPANS: Dict[str, list] = {}  # name -> its _TOTALS, in order
_SPANS_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: the spans open on this thread


class _Span:
    """One span while a profiler runs (module docstring)."""

    __slots__ = ("name", "event", "stack", "child_ns", "t0")

    def __init__(self, name: str):
        self.name = name
        self.event = _HostEvent(name)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.stack = stack
        self.child_ns = 0
        stack.append(self)
        self.event.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.event.__exit__(*exc)
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        with _SPANS_LOCK:
            tot = _SPANS.get(self.name)
            if tot is None:
                tot = _SPANS[self.name] = [0, 0, 0, 0]
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - self.child_ns
            tot[3] += not stack
        return False


def span(name: str):
    """A context that marks the port's layer `name` while a
    `torch.profiler` runs, and the shared no-op context otherwise (module
    docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_totals() -> Dict[str, dict]:
    """A copy of the spans' totals since the last `reset_spans()`:
    {name: {"count", "total_ns", "self_ns", "roots"}}."""
    with _SPANS_LOCK:
        return {name: dict(zip(_TOTALS, t)) for name, t in _SPANS.items()}


def reset_spans() -> None:
    """Clear the spans' totals."""
    with _SPANS_LOCK:
        _SPANS.clear()


def device_busy_ms(fn: Callable, calls: int = 10) -> Optional[float]:
    """The card's busy time per call of `fn()`: the summed durations of
    the device events in a `torch.profiler` trace of `calls` calls (after
    one untraced call), divided by `calls`; None where the trace holds no
    device event."""
    measuring_device("cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / calls / 1e3 if us else None


def speed_of_light_spmv_s(nnz: int, hbm_gbps: float = 3350.0) -> float:
    """Bandwidth-bound lower bound for CSR SpMV: the data and indices
    streamed once, nnz * (4 data + 4 index) bytes, at the H100 SXM's
    3.35 TB/s of HBM3 (NVIDIA's data sheet) unless `hbm_gbps` says
    otherwise."""
    return (nnz * 8) / (hbm_gbps * 1e9)


def nnz_per_second(nnz: int, time_ms: float) -> float:
    return nnz / (time_ms * 1e-3) if time_ms > 0 else float("inf")
