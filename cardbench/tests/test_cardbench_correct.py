"""The check must fail the control and every fault a cell can have.

Each test drives a whole run of a cell at its laws' small sizes on the CPU
(the harness's look for a card skipped), with the timed call replaced by
one that the cell's entry states (`entries/<entry>.py`):

* `control`: the plain reference computed from operands rounded one
  precision below the configuration's dtype (TF32 for float32, float32
  for float64), in the program's place;
* each of the entry's `faults`: for SpGEMM an answer altered where it is
  produced (`altered`), the rows of C's second half left out
  (`half_rows`), and for the plan a step that returns its state unchanged
  (`unchanged`: the first answer for every later value pair; the other
  SpGEMM cells multiply the same operands every call).

Each must be caught by a number of the check, not by a call that raised.
The exchange between chips does not exist in these one-chip cells.  The
card test runs the port's own lower-precision path (the entry's
`card_control`: SpGEMM's TF32 `precision="default"`), the control on the
card, and skips a cell whose entry has none.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import check, harness  # noqa: E402

CELLS = [w["name"] for w in harness.read_json(ROOT / "BENCHMARK.json")
         ["workloads"]]
SEED = 2**31 + 77


def entry(cell):
    return harness.load_entry(harness.load_cell(cell, ROOT), ROOT)


# (cell, what) for the control and every fault of each cell's entry
FAULTS = [(cell, what) for cell in CELLS
          for what in ["control", *entry(cell).faults]]


def run(cell, wrap=None, device="cpu", **kw):
    result, lines = harness.run_cell(cell, SEED, 0.5, False, device=device,
                                     config_patch=harness.small(cell, ROOT),
                                     wrap=wrap, **kw)
    return result


def caught_by_a_number(r):
    """Not correct, with every call made and some number over its limit."""
    return (not r["correct"] and r["failed"] == 0
            and bool(check.numbers_over(r["checks"])))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["value_err"]["value"] < 1e-6


@pytest.mark.parametrize("cell,what", FAULTS)
def test_fault_is_not_correct(cell, what):
    e = entry(cell)
    r = run(cell, wrap=e.control if what == "control" else e.faults[what])
    assert caught_by_a_number(r), r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_port_tf32_path_is_not_correct_on_the_card(card, cell):
    low = entry(cell).card_control
    if low is None:
        pytest.skip(f"{cell}: its entry has no lower-precision path of the "
                    "port's own (card_control is None)")
    assert run(cell, device=card)["correct"]
    r = run(cell, device=card, **low)
    assert caught_by_a_number(r), r["checks"]
