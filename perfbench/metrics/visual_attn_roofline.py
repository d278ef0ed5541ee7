"""visual_attn_roofline: the traced site calls' attention bounds (the
harness's, at each plan's kept pairs; perfbench/peaks.py) over the device
time of the attention kernels launched inside the program's ``rsa.attn``
ranges (the visual rows' K1 / K2 and the key split's merge), in %.
Unlike ``attn_roofline`` it leaves out attention kernels launched
elsewhere: the warm gate's dense K1 and the cross-attention's K3."""

from perfbench.spans import enclosing, ranges
from perfbench.trace import is_attention

ATTN = "rsa.attn"


def read(r):
    if not ranges(r, ATTN) or not r.attn_bound_s:
        return None
    seconds = sum(o.dur for o, names in zip(r.ops, enclosing(r))
                  if ATTN in names and is_attention(o.name)) / 1e9
    if not seconds:
        return None
    return 100.0 * r.attn_bound_s / seconds
