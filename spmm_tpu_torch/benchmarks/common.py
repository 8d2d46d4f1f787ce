"""What the speed drivers share: the device they measure on, the sweep's
skip rule, device busy time, and the JSON rows."""

from __future__ import annotations

import json
from typing import Callable, Optional

import torch

from spmm_tpu_torch.utils.profiler import (BenchResult, card_info,
                                           cleanup_device, device_busy_ms,
                                           repeat_op)

# the words of `spgemm`'s refusal past the int32 product workspace
# (`ops/spgemm.py::_check_products`)
PRODUCT_LIMIT = "intermediate products, past the 2^31"
# the `--dtype` choices of the SpGEMM drivers (the generator's dtypes)
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def driver_device(driver: str, device: str) -> torch.device:
    """The device a driver measures on; raises, before anything is
    measured, where the card is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{driver} measures on the card unless --device cpu is given, "
            "and torch.cuda.is_available() is false")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name and power limit, or "cpu"."""
    return card_info() if device.type == "cuda" else "cpu"


def timed(name: str, fn: Callable, runs: int, warmup: int,
          device: torch.device) -> Optional[BenchResult]:
    """`repeat_op(name, fn)`: CUDA-event median per call on the card, the
    host clock on the CPU; None, after a `[SKIP]` line, where the call runs
    out of memory or passes ESC's int32 product limit.  Every other error
    is raised."""
    try:
        return repeat_op(name, fn, runs=runs, warmup=warmup, device=device)
    except ValueError as e:
        if PRODUCT_LIMIT not in str(e):
            raise
        print(f"[SKIP] {name}: ValueError: {str(e)[:200]}")
        cleanup_device()
        return None


def busy_ms(fn: Callable, device: torch.device, calls: int = 5
            ) -> Optional[float]:
    """The card's busy time per call of `fn` from a profiler trace of
    `calls` calls, or of at least 20 where that trace came back without
    device events (the card's profiler drops some: PERF.md §6, PR 12 and
    13); None on the CPU, or where both traces are empty."""
    if device.type != "cuda" or calls < 1:
        return None
    for n in (calls, max(20, 4 * calls)):
        ms = device_busy_ms(fn, n)
        if ms is not None:
            return ms
    return None


def emit(row: dict, as_json: bool) -> dict:
    if as_json:
        print(json.dumps(row), flush=True)
    return row
