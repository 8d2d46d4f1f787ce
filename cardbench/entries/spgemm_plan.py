"""Entry `spgemm_plan`: set-up builds `spgemm_plan(A, B)` once; call i is
`plan(a_values[i % pool], b_values[i % pool])`, new values on A's and B's
fixed structures, as AMG re-setup and time stepping send them.

Traffic parameters: `pool`, the number of value pairs, and
`pool_seed_offset`: A's values come from the run's seed plus it, B's from
the seed plus it plus one.  The program gets its own copies of the pool.
Faults and controls: those of `entries/spgemm.py`, and `unchanged`.
"""

from __future__ import annotations

from cardbench import operands
from cardbench.entries.spgemm import (altered, answer, card_control,  # noqa
                                      control, csr, half_rows)
from cardbench.reference import spgemm as reference
from cardbench.work import spgemm as counts


class Timed:
    """As `entries/spgemm.py`'s `Timed`, for the plan's call."""

    def __init__(self, mats, traffic, config, precision, seed, device):
        from spmm_tpu_torch.ops.serving import spgemm_plan

        self.a, self.b = mats["A"], mats["B"]
        self.pool = int(traffic["pool"])
        s = seed + int(traffic["pool_seed_offset"])
        dtype = self.a.data.dtype
        self.a_vals = operands.values_pool(self.pool, self.a.data.numel(), s,
                                           dtype, device)
        self.b_vals = operands.values_pool(self.pool, self.b.data.numel(),
                                           s + 1, dtype, device)
        # the program's own copies, one tensor a row, so that a call only
        # picks a list entry
        self._a_vals = list(self.a_vals.clone().unbind())
        self._b_vals = list(self.b_vals.clone().unbind())
        self._plan = spgemm_plan(csr(self.a, device, config["canonical"]),
                                 csr(self.b, device, config["canonical"]),
                                 precision=precision)

    def call(self, i):
        j = i % self.pool
        return self._plan(self._a_vals[j], self._b_vals[j])

    def key(self, i):
        """Which value pair call i multiplies."""
        return i % self.pool

    answer = staticmethod(answer)

    def expected(self, key, operand_round=None):
        return reference.spgemm(self.a._replace(data=self.a_vals[key]),
                                self.b._replace(data=self.b_vals[key]),
                                operand_round)

    def work(self, expected) -> dict:
        return counts.plan_call(self.a, self.b, expected[1].numel())

    def close(self):
        self._plan = self._a_vals = self._b_vals = None


def unchanged(timed):
    """A state that never changes: the first answer, for every later value
    pair."""
    first = []

    def call(i):
        out = timed.call(i)
        if not first:
            first.append(out)
        return first[0]
    return call


faults = {"altered": altered, "half_rows": half_rows, "unchanged": unchanged}
