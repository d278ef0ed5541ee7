"""attn_roofline: the traced site calls' attention bounds (per call
the larger of its operations over the bf16 peak and its bytes over the
memory bandwidth, perfbench/peaks.py) over the device time of the
attention kernels and merges, in %."""

from perfbench.trace import is_attention


def read(r):
    seconds = sum(o.dur for o in r.ops if is_attention(o.name)) / 1e9
    if not seconds or not r.attn_bound_s:
        return None
    return 100.0 * r.attn_bound_s / seconds
