"""rectify_ms: device ms per step of the operations launched inside the
program's ``rsa.rectify`` ranges: the site's rectification,
``sparse_out * R + comp`` over the kernel's output in fp32."""

from perfbench.spans import enclosing, ranges

RECTIFY = "rsa.rectify"


def read(r):
    if not ranges(r, RECTIFY) or not r.steps:
        return None
    ops = [o for o, names in zip(r.ops, enclosing(r)) if RECTIFY in names]
    return r.sum_ms(ops) / r.steps
