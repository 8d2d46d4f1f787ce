"""The check must fail the control and every fault a cell can have.

Each test drives a whole run of a cell at a small size on the CPU (the
harness's look for a card skipped), with the timed call replaced:

* the control: the plain reference computed from TF32-rounded operands, the
  precision just below the configuration's IEEE float32, in the program's
  place;
* an answer altered where it is produced: one value of C changed;
* half of the work left out: the rows of C's second half dropped;
* a step that returns its state unchanged: the plan's first answer
  returned for every later value pair (only the plan cell has a state that
  changes between calls; the other cells multiply the same operands every
  call).

The exchange between chips does not exist in these one-chip cells.  The
card test runs the port's own TF32 path (`precision="default"`), the
control on the card, at a size a test run holds.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import harness  # noqa: E402

CELLS = [w["name"] for w in harness.read_json(ROOT / "BENCHMARK.json")
         ["workloads"]]
SEED = 2**31 + 77


def patch(n):
    return {"matrices": {
        "A": {"rows": n, "cols": n, "density": 0.1, "seed_offset": 0},
        "B": {"rows": n, "cols": n, "density": 0.1, "seed_offset": 1}}}


def run(cell, wrap=None, device="cpu", n=64, precision=None):
    result, lines = harness.run_cell(cell, SEED, 0.5, False, device=device,
                                     config_patch=patch(n), wrap=wrap,
                                     precision=precision)
    return result


def csr(ip, ix, v, cols):
    from spmm_tpu_torch.sparse.csr import CSR

    return CSR._wrap(ip.to(torch.int32), ix.to(torch.int32),
                     v.to(torch.float32), (ip.numel() - 1, cols),
                     canonical=True)


def control(timed):
    return lambda i: csr(*timed.expected(timed.key(i), "tf32"),
                         timed.b.shape[1])


def altered(timed):
    def call(i):
        out = timed.call(i)
        out.data[out.data.numel() // 2] += 0.01
        return out
    return call


def half_rows(timed):
    def call(i):
        out = timed.call(i)
        m = out.indptr.numel() - 1
        keep = int(out.indptr[m // 2])
        ip = torch.clamp(out.indptr, max=keep)
        return csr(ip, out.indices[:keep], out.data[:keep], out.shape[1])
    return call


def unchanged(timed):
    first = []

    def call(i):
        out = timed.call(i)
        if not first:
            first.append(out)
        return first[0]
    return call


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["value_err"]["value"] < 1e-6


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [control, altered, half_rows])
def test_fault_is_not_correct(cell, fault):
    r = run(cell, wrap=fault)
    assert not r["correct"], r["checks"]


def test_plan_state_unchanged_is_not_correct():
    r = run("n1024-d0.1.plan", wrap=unchanged)
    assert not r["correct"], r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_port_tf32_path_is_not_correct_on_the_card(card, cell):
    assert run(cell, device=card, n=256)["correct"]
    r = run(cell, device=card, n=256, precision="default")
    assert not r["correct"], r["checks"]
