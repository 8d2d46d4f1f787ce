"""Entry `spgemm`: `spgemm(A, B, **kwargs)` on fixed operands, each call
through the port's public entry with the configuration's precision.

Traffic parameters: `kwargs`, the keyword arguments of every call (`alg`,
`chunk_fraction`, ...).  The program gets its own copies of A and B; the
reference reads the benchmark's.
"""

from __future__ import annotations

from cardbench.reference import spgemm as reference
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
    reference's; `work(nnz_c)`, the call's operations and bytes;
    `close()`, which frees the program's state."""

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

    def work(self, nnz_c: int) -> dict:
        return counts.spgemm_call(self.a, self.b, nnz_c)

    def close(self):
        """Free the program's state (the benchmark's inputs stay)."""
        self._A = self._B = None
