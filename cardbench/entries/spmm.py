"""Entry `spmm`: `spmm(A, H_i)` through the port's public SpMM on a fixed
A, call i taking H_i = hs[i % pool], as each epoch of a graph network
aggregates fresh node features over one graph.

Traffic parameters: `plan`, false (the only value taken): no plan, the
port's default path, which makes its chunk plan per call; `k`, the width
of H; `pool`, the number of H matrices (n x k), drawn from U[0, 1) in the
configuration's dtype from the run's seed plus `pool_seed_offset`.  The
program gets its own copies of A and the pool; the reference reads the
benchmark's.  The answer is Y, a dense (m, k) matrix, copied to the host
into one of `harness.SAMPLES` buffers pinned in set-up: a Y of 1.68 GB
copied to fresh pageable memory holds the window for about 0.7 s, the
time of some fifty calls, where a pinned one moves at the link's speed.
"""

from __future__ import annotations

import torch

from cardbench import operands
from cardbench.entries.spgemm import csr
from cardbench.harness import SAMPLES
from cardbench.reference import spmm as reference
from cardbench.reference.rounding import LOWER
from cardbench.work import spmm as counts


class Timed:
    """As `entries/spgemm.py`'s `Timed`, for `spmm`."""

    def __init__(self, mats, traffic, config, precision, seed, device):
        from spmm_tpu_torch.ops.spmm import spmm

        if traffic["plan"]:
            raise ValueError("entry spmm: a plan is not taken (plan: false)")
        self.a = mats["A"]
        self.k = int(traffic["k"])
        self.pool = int(traffic["pool"])
        s = seed + int(traffic["pool_seed_offset"])
        n = self.a.shape[1]
        self.hs = operands.values_pool(self.pool, n * self.k, s,
                                       self.a.data.dtype, device
                                       ).view(self.pool, n, self.k)
        self._spmm = spmm
        self._A = csr(self.a, device, config["canonical"])
        self._hs = list(self.hs.clone().unbind())
        self._host = ([torch.empty((self.a.shape[0], self.k),
                                   dtype=self.a.data.dtype, pin_memory=True)
                       for _ in range(SAMPLES)]
                      if torch.device(device).type == "cuda" else [])

    def call(self, i):
        return self._spmm(self._A, self._hs[i % self.pool])

    def key(self, i):
        """Which H call i multiplies."""
        return i % self.pool

    def answer(self, out):
        """Y on the host: in a pinned buffer while one is left."""
        return self._host.pop().copy_(out) if self._host else out.cpu()

    def expected(self, key, operand_round=None):
        return reference.spmm(self.a, self.hs[key], operand_round)

    def work(self, expected) -> dict:
        return counts.spmm_call(self.a, self.k)

    def close(self):
        self._A = self._hs = None


def control(timed):
    """Y from the reference on A and H rounded one precision below."""
    low = LOWER[timed.a.data.dtype]
    return lambda i: timed.expected(timed.key(i), low).to(timed.a.data.dtype)


def altered(timed):
    """One value of Y changed where it is produced."""
    def call(i):
        out = timed.call(i)
        out.view(-1)[out.numel() // 2] += 0.01
        return out
    return call


def half_rows(timed):
    """The rows of Y's second half left out: zero, as in a buffer that
    they were never written to."""
    def call(i):
        out = timed.call(i)
        out[out.shape[0] // 2:] = 0
        return out
    return call


def stale(timed):
    """Each call answers with the previous call's Y, one step late (the
    first with its own): with two or more H in turn, the Y of another H."""
    last = []

    def call(i):
        out = timed.call(i)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out
    return call


faults = {"altered": altered, "half_rows": half_rows, "stale": stale}
# `spmm` takes no precision: the port has no lower-precision path of its own
card_control = None
