"""gemm_ms: device ms per step of the matrix-product kernels (cuBLAS's,
by name) in the traced steps."""

from perfbench.trace import is_gemm


def read(r):
    ops = [o for o in r.ops if is_gemm(o.name)]
    if not ops or not r.steps:
        return None
    return r.sum_ms(ops) / r.steps
