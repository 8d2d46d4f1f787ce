"""Entry `spmv`: `spmv(A, x_i, plan=P)` through the port's public SpMV on
a fixed A, call i taking x_i = xs[i % pool], as a solver's iterations
send new vectors to one matrix.

Traffic parameters: `plan`, true for P = `spmv_plan(A)` made once in
set-up (a plan of None where the port makes none for A), false for P =
None, the port's per-call path; `pool`, the number of x vectors, drawn
from U[0, 1) in the configuration's dtype from the run's seed plus
`pool_seed_offset`.  The program gets its own copies of A and the pool;
the reference reads the benchmark's.  The answer is y, a dense vector.
"""

from __future__ import annotations

from cardbench import operands
from cardbench.entries.spgemm import csr
from cardbench.reference import spmv as reference
from cardbench.reference.rounding import LOWER
from cardbench.work import spmv as counts


def answer(out):
    """y, copied to the host."""
    return out.cpu()


class Timed:
    """As `entries/spgemm.py`'s `Timed`, for `spmv`."""

    def __init__(self, mats, traffic, config, precision, seed, device):
        from spmm_tpu_torch.ops.spmv import spmv, spmv_plan

        self.a = mats["A"]
        self.pool = int(traffic["pool"])
        s = seed + int(traffic["pool_seed_offset"])
        self.xs = operands.values_pool(self.pool, self.a.shape[1], s,
                                       self.a.data.dtype, device)
        self._spmv = spmv
        self._A = csr(self.a, device, config["canonical"])
        self._xs = list(self.xs.clone().unbind())
        self._plan = spmv_plan(self._A) if traffic["plan"] else None

    def call(self, i):
        return self._spmv(self._A, self._xs[i % self.pool], plan=self._plan)

    def key(self, i):
        """Which x call i multiplies."""
        return i % self.pool

    answer = staticmethod(answer)

    def expected(self, key, operand_round=None):
        return reference.spmv(self.a, self.xs[key], operand_round)

    def work(self, expected) -> dict:
        return counts.spmv_call(self.a)

    def close(self):
        self._A = self._plan = self._xs = None


def control(timed):
    """y from the reference on A and x rounded one precision below."""
    low = LOWER[timed.a.data.dtype]
    return lambda i: timed.expected(timed.key(i), low).to(timed.a.data.dtype)


def altered(timed):
    """One value of y changed where it is produced."""
    def call(i):
        out = timed.call(i)
        out[out.numel() // 2] += 0.01
        return out
    return call


def half_rows(timed):
    """The rows of y's second half left out: zero, as in a buffer that
    they were never written to."""
    def call(i):
        out = timed.call(i)
        out[out.numel() // 2:] = 0
        return out
    return call


def unchanged(timed):
    """A state that never changes: the first y, for every later x."""
    first = []

    def call(i):
        out = timed.call(i)
        if not first:
            first.append(out.clone())
        return first[0]
    return call


faults = {"altered": altered, "half_rows": half_rows, "unchanged": unchanged}
# `spmv` takes no precision: the port has no lower-precision path of its own
card_control = None
