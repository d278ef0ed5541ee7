"""cross_attn_ms: device ms per step of the operations launched inside
the program's ``rsa.cross`` ranges: the dense cross-attention to the
text slots (K3)."""

from perfbench.dense_peaks import CROSS, per_step_ms


def read(r):
    return per_step_ms(r, CROSS)
