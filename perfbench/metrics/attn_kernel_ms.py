"""attn_kernel_ms: device ms per step of the attention kernels
(``hopper_attn_kernel<...>``: K1, K2) and the key split's merge."""

from perfbench.trace import is_attention


def read(r):
    ops = [o for o in r.ops if is_attention(o.name)]
    if not ops or not r.steps:
        return None
    return r.sum_ms(ops) / r.steps
