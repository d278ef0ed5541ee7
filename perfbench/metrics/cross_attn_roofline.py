"""cross_attn_roofline: the cross-attention calls' bounds (from the sizes
each ``rsa.cross`` range carries; perfbench/dense_peaks.py) over the
device time of the operations launched inside those ranges, in %."""

from perfbench.dense_peaks import CROSS, roofline_pct


def read(r):
    return roofline_pct(r, CROSS)
