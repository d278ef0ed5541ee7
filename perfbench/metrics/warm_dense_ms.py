"""warm_dense_ms: device ms per step of the operations launched inside
the program's ``rsa.dense`` ranges: the warm gate's dense self-attention
(K1 over full index lists, the windowed dense route; its query pad and
list build)."""

from perfbench.dense_peaks import DENSE, per_step_ms


def read(r):
    return per_step_ms(r, DENSE)
