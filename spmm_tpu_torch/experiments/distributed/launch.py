"""Start N ranks of a module on one host and wait for them.

The port's counterpart of `experiments/distributed/run_multiprocess.sh`:
every rank is `python -m <module> <args> --nprocs N --rank r --store PATH
--device DEVICE`, where PATH is a FileStore file in a fresh temporary
directory (no TCP port to pick).  A rank that exits non-zero fails the
run: the others are stopped, and so is every rank still running at the
time limit.  NCCL takes one rank per card, so on the card N is at most the
number of cards.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Sequence


def launch(module: str, args: Sequence[str], nprocs: int, device: str,
           timeout_s: float) -> int:
    """Run `nprocs` ranks of `module`; 0 where every rank exited 0, else
    the first non-zero exit code (124 at the time limit)."""
    with tempfile.TemporaryDirectory(prefix="spmm_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *args, "--nprocs", str(nprocs),
             "--rank", str(r), "--store", store, "--device", device])
            for r in range(nprocs)]
        code = 0
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    code = failed[0] if failed else 124
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        return code or next((p.returncode for p in procs if p.returncode),
                            0)


def world_sizes(requested, device: str):
    """(sizes to run, notes on the ones left out): on the card a world
    size needs one card a rank; the default is 1, 2, 4, 8 up to the cards
    there are (on the CPU: 1, 2, 4)."""
    import torch

    cards = torch.cuda.device_count() if device == "cuda" else None
    if requested is None:
        top = cards if cards is not None else 4
        requested = [d for d in (1, 2, 4, 8) if d <= top]
    run, notes = [], []
    for d in requested:
        if cards is not None and d > cards:
            notes.append(f"D={d}: not run: it needs {d} cards and this "
                         f"machine has {cards} (NCCL takes one rank per "
                         "card)")
        else:
            run.append(d)
    return run, notes


def run_ranks(module: str, args: Sequence[str], nprocs: int, device: str,
              timeout_s: float):
    """`launch` of `nprocs` ranks that write rank 0's JSON result to the
    file named by `--result`; returns that result (raises where a rank
    failed)."""
    import json

    with tempfile.TemporaryDirectory(prefix="spmm_result_") as tmp:
        path = os.path.join(tmp, "result.json")
        code = launch(module, [*args, "--result", path], nprocs, device,
                      timeout_s)
        if code:
            raise RuntimeError(f"{module} at {nprocs} rank(s) exited {code}")
        with open(path) as f:
            return json.load(f)
