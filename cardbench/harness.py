"""One run of one cell: set-up, the measured window, the check, the result.

The traffic is a closed loop: one caller makes call i, waits for the device
(`torch.cuda.synchronize()`), then makes call i + 1, until `seconds` have
passed since the window opened.  Each call is timed on the host clock from
entering the port's entry until the synchronize returns.  `attempted`
counts the calls begun in the window, `failed` those that raised.

The check compares a sample of the window's answers with the plain
reference, after the window has closed and the program's state is freed:
at `SAMPLES` times drawn from the seed, the first call that begins at or
after the time has its answer copied to the host (outside the call's own
timing).  A run is correct when no call failed, at least one answer was
compared, and every compared number is within its limit
(`workloads/<cell>.json`).
"""

from __future__ import annotations

import contextlib
import gc
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from cardbench import check, operands, tracing
from cardbench.files import load_file, read_json

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SAMPLES = 5
# the JAX package and JAX itself, by whole top-level module name
BANNED = ("jax", "jaxlib", "flax", "spmm_tpu")


class Refused(RuntimeError):
    """The run cannot be made here: no result is printed."""


@dataclass
class Cell:
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    """What one run measured; the metric readers take their numbers from
    it."""
    setup_s: float
    window_s: float
    calls_s: List[float]
    attempted: int
    failed: int
    peak_window_bytes: int
    launches: Dict[str, int]
    work: Optional[dict] = None
    peaks: Optional[dict] = None
    trace: Optional[tracing.Trace] = None


def for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    here = root / "cardbench"
    return Cell(config=read_json(root / config["file"]),
                traffic=read_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(here / "workloads" / f"{name}.json")
                ["limits"],
                chips=int(w["chips"]),
                end_to_end=for_cell(spec["end_to_end"], name),
                per_layer=for_cell(spec["per_layer"], name))


def load_entry(cell: Cell, root: Path = ROOT):
    """`cardbench/entries/<entry>.py` of the cell's traffic: its `Timed`,
    and for the tests its `faults`, `control` and `card_control`."""
    return load_file(root / "cardbench" / "entries"
                     / f"{cell.traffic['entry']}.py")


def small(workload: str, root: Path = ROOT) -> dict:
    """The `config_patch` that runs a cell at its laws' small sizes."""
    return operands.small(load_cell(workload, root).config, root)


def load_reader(name: str, root: Path = ROOT) -> Callable:
    """`read` of `cardbench/metrics/<name>.py`; a metric `<base>.<group>`
    without a file of its own, one quantity held apart for a group of
    cells, is read by `<base>.py`."""
    metrics = root / "cardbench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.is_file():
        path = metrics / f"{name.split('.')[0]}.py"
    return load_file(path).read


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def import_port():
    """The port's launch counter; the port has to be this checkout's."""
    try:
        import spmm_tpu_torch
    except ImportError as e:
        raise Refused(f"the program is not here: {e}") from e
    where = Path(spmm_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise Refused(f"spmm_tpu_torch comes from {where}, not from "
                      f"{ROOT}")
    from spmm_tpu_torch.ops.kernels import _build

    return _build


def power_limit() -> Optional[float]:
    """The card's power limit in watts, as `nvidia-smi` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def sample_times(seed: int, seconds: float) -> List[float]:
    rng = random.Random(seed)
    return sorted(rng.uniform(0, 0.9 * seconds) for _ in range(SAMPLES))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(timed, call, seconds, device, traced, seed):
    """The measured loop.  Returns (per-call seconds, calls begun, calls
    failed, window seconds, kept answers [(key, answer)], errors)."""
    due = sample_times(seed, seconds)
    kept, times, errors = [], [], []
    failed = i = 0
    mark = (torch.profiler.record_function if traced
            else lambda name: contextlib.nullcontext())
    with mark(tracing.WINDOW):
        t_open = time.perf_counter()
        end = t_open + seconds
        while (t0 := time.perf_counter()) < end:
            i += 1
            try:
                with mark("cardbench.call"):
                    out = call(i - 1)
                    sync(device)
            except Exception as e:  # a failed call is counted, not fatal
                failed += 1
                errors.append(f"call {i - 1}: {type(e).__name__}: {e}")
                sync(device)
                continue
            times.append(time.perf_counter() - t0)
            if due and t0 - t_open >= due[0]:
                due = [t for t in due if t > t0 - t_open]
                with mark(tracing.KEEP):
                    kept.append((timed.key(i - 1), timed.answer(out)))
            del out
        t_close = time.perf_counter()
    return times, i, failed, t_close - t_open, kept, errors


def compare(timed, kept) -> dict:
    """Every kept answer against the reference: the worst of each number,
    the last reference answer (for the work count), and how many answers
    were compared."""
    refs, worst = {}, {}
    ref = None
    for key, got in kept:
        if key not in refs:
            refs[key] = check.host(timed.expected(key))
        ref = refs[key]
        for name, value in check.numbers_of(got, ref).items():
            old = worst.get(name, 0.0)
            worst[name] = (None if value is None or old is None
                           else max(old, value))
    return {"numbers": worst, "ref": ref, "compared": len(kept)}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             root: Path = ROOT, config_patch: Optional[dict] = None,
             precision: Optional[str] = None,
             wrap: Optional[Callable] = None):
    """Set up, measure and check one run; returns (result, check lines).

    `config_patch`, `precision` and `wrap` are for the tests and the
    control only: a smaller configuration, another precision than the
    configuration states, and `wrap(timed)`, a timed call to make in
    place of the entry's own."""
    t_torch = time.perf_counter()
    t_start = t_torch if t_start is None else t_start
    cell = load_cell(workload, root)
    config = dict(cell.config, **(config_patch or {}))
    precision = precision or config.get("precision")
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise Refused(f"{workload} needs {cell.chips} CUDA card(s); "
                      f"{torch.cuda.device_count()} here")
    marks = [("start", t_start), ("torch", t_torch),
             ("card", time.perf_counter())]
    build = import_port()
    entry = load_entry(cell, root)
    marks.append(("import", time.perf_counter()))
    mats = operands.make(config, seed, device, root)
    sync(device)
    marks.append(("operands", time.perf_counter()))
    timed = entry.Timed(mats, cell.traffic, config, precision, seed,
                            device)
    call = wrap(timed) if wrap else timed.call
    sync(device)
    marks.append(("entry", time.perf_counter()))
    for i in range(int(cell.traffic["warmup_calls"])):
        call(i)
        sync(device)
    marks.append(("warmup", time.perf_counter()))
    gc.collect()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    launches0 = dict(build.LAUNCHES)
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        times, attempted, failed, window_s, kept, errors = window(
            timed, call, seconds, device, traced, seed)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = {k: v - launches0.get(k, 0) for k, v in build.LAUNCHES.items()}

    timed.close()
    del call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    seen = compare(timed, kept)
    run = Run(setup_s=setup_s, window_s=window_s, calls_s=times,
              attempted=attempted, failed=failed,
              peak_window_bytes=peak - base, launches=launches)
    if seen["ref"] is not None:
        run.work = timed.work(seen["ref"])
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run.peaks = read_json(HERE / "peaks.json").get(kind)
    if prof is not None:
        run.trace = tracing.summarize(*tracing.raw_events(prof))
        del prof

    verdict, lines, checks = check.judge(seen, cell.limits, failed,
                                         SAMPLES)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": max(setup_peak, peak)}
    if cuda:
        dev["power_limit_w"] = power_limit()
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": verdict, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top("device_ops"),
                               "idle_gaps": run.trace.top("idle_gaps")}
    result["checks"] = checks
    setup = " ".join(f"{name} {t - marks[k][1]:.3f}" for k, (name, t)
                     in enumerate(marks[1:]))
    k = len(times) // 3
    thirds = " ".join(f"{sum(p) / len(p) * 1e3:.5f}" for p in
                      (times[:k], times[k:2 * k], times[2 * k:]) if p)
    return result, errors[:3] + [f"setup_s by step: {setup}",
                                 f"mean call ms by third: {thirds}"] + lines
