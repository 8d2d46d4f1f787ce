"""What a run loads and reads, and where it refuses to run.

Each cell's set-up and calls run at its laws' small sizes on the CPU in a
fresh process that records every file it opens: afterwards no module of
JAX or of the JAX package `spmm_tpu` is loaded (top-level names compared
whole: `spmm_tpu_torch` is the port) and no file under `benchmarks/` was
opened.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]
CHILD = r"""
import json, os, sys
from pathlib import Path
root = Path(sys.argv[1])
opened = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        opened.append(os.fsdecode(args[0]))

sys.addaudithook(hook)
sys.path.insert(0, str(root))
from cardbench import harness

spec = harness.read_json(root / "BENCHMARK.json")
calls = {}
for w in spec["workloads"]:
    result, _ = harness.run_cell(w["name"], 2**31 + 9, 0.05, False,
                                 device="cpu",
                                 config_patch=harness.small(w["name"], root))
    calls[w["name"]] = result["attempted"]
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "spmm_tpu"))
bench = root.resolve() / "benchmarks"
read = sorted({p for p in opened
               if bench == Path(p).resolve()
               or bench in Path(p).resolve().parents})
print(json.dumps({"calls": calls, "banned": banned, "read": read}))
"""


def env():
    e = dict(os.environ)
    e.pop("PYTHONPATH", None)
    return e


def test_a_run_loads_no_jax_and_reads_no_benchmarks_folder():
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env())
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["calls"] and all(n >= 1 for n in seen["calls"].values())
    assert seen["banned"] == []
    assert seen["read"] == []


def test_no_card_no_result():
    """On a machine without a CUDA card the command prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_refused_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the program is missing and nothing runs."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from cardbench import harness; harness.import_port()")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env())
    assert out.returncode != 0
    assert "the program is not here" in out.stderr
