"""Entry `spgemm`: `spgemm(A, B, **kwargs)` on fixed operands, each call
through the port's public entry with the configuration's precision.

Traffic parameters: `kwargs`, the keyword arguments of every call (`alg`,
`chunk_fraction`, ...).  The program gets its own copies of A and B; the
reference reads the benchmark's.

For the tests, every entry module states what its check has to catch:
`faults`, each of which wraps the set-up `Timed` into a faulty call;
`control(timed)`, the plain reference from operands rounded one precision
below the configuration's dtype, in the program's place; and
`card_control`, the keyword arguments of `harness.run_cell` that switch on
the port's own lower-precision path, or None where the port has none.
"""

from __future__ import annotations

import torch

from cardbench.operands import Csr
from cardbench.reference import spgemm as reference
from cardbench.reference.rounding import LOWER
from cardbench.work import spgemm as counts


def csr(m, device, canonical: bool):
    """The benchmark's matrix `m` as the port's CSR, on copies."""
    from spmm_tpu_torch.sparse.csr import CSR

    return CSR.from_parts(m.indptr.clone(), m.indices.clone(),
                          m.data.clone(), m.shape, canonical=canonical,
                          device=device)


def answer(out):
    """The CSR a call returned, copied to the host."""
    return out.indptr.cpu(), out.indices.cpu(), out.data.cpu()


class Timed:
    """The entry set up for the window.  Every entry's `Timed` has these
    methods: `call(i)`, the timed call i; `key(i)`, which inputs it takes;
    `answer(out)`, its result on the host; `expected(key)`, the plain
    reference's; `work(expected)`, the call's operations and bytes, given
    the reference's answer of a compared call; `close()`, which frees the
    program's state."""

    def __init__(self, mats, traffic, config, precision, seed, device):
        from spmm_tpu_torch.ops.spgemm import spgemm

        self.a, self.b = mats["A"], mats["B"]
        self._spgemm = spgemm
        self._A = csr(self.a, device, config["canonical"])
        self._B = csr(self.b, device, config["canonical"])
        self._kwargs = dict(traffic.get("kwargs", {}), precision=precision)

    def call(self, i):
        return self._spgemm(self._A, self._B, **self._kwargs)

    def key(self, i):
        """Which inputs call i multiplies: always the same."""
        return 0

    answer = staticmethod(answer)

    def expected(self, key, operand_round=None):
        return reference.spgemm(self.a, self.b, operand_round)

    def work(self, expected) -> dict:
        return counts.spgemm_call(self.a, self.b, expected[1].numel())

    def close(self):
        """Free the program's state (the benchmark's inputs stay)."""
        self._A = self._B = None


def control(timed):
    """C from the reference on operands rounded one precision below."""
    low = LOWER[timed.a.data.dtype]
    shape = (timed.a.shape[0], timed.b.shape[1])

    def call(i):
        ip, ix, v = timed.expected(timed.key(i), low)
        return Csr(ip, ix, v.to(timed.a.data.dtype), shape)
    return call


def altered(timed):
    """One value of C changed where it is produced."""
    def call(i):
        out = timed.call(i)
        out.data[out.data.numel() // 2] += 0.01
        return out
    return call


def half_rows(timed):
    """The rows of C's second half left out."""
    def call(i):
        out = timed.call(i)
        m = out.indptr.numel() - 1
        keep = int(out.indptr[m // 2])
        return Csr(torch.clamp(out.indptr, max=keep), out.indices[:keep],
                   out.data[:keep], out.shape)
    return call


faults = {"altered": altered, "half_rows": half_rows}
# the port's TF32 value GEMMs
card_control = {"precision": "default"}
