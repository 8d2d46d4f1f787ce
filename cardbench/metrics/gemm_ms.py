"""gemm_ms: device time per call of the GEMM kernels, matched by name in
the traced window: cuBLAS's `*gemm*` and `nvjet*` kernels and its split-K
reductions (`cublasLt::splitKreduce_kernel`), CUTLASS's kernels."""

import re

GEMM = re.compile(r"gemm|nvjet|cutlass|cublas", re.IGNORECASE)


def read(run):
    if run.trace is None or not run.calls_s:
        return None
    s = sum(t for name, t in run.trace.device_ops.items() if GEMM.search(name))
    return s / len(run.calls_s) * 1e3 if s else None
