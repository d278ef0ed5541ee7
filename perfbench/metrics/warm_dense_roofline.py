"""warm_dense_roofline: the warm gate's dense self-attention calls'
bounds (each call's operations over the bf16 peak or its bytes over the
memory bandwidth, from the sizes its ``rsa.dense`` range carries;
perfbench/dense_peaks.py) over the device time of the operations
launched inside those ranges, in %."""

from perfbench.dense_peaks import DENSE, roofline_pct


def read(r):
    return roofline_pct(r, DENSE)
