"""plan_ms: device ms per step of the operations queued inside the
benchmark's host range around ``build_sparse_plan``."""


def read(r):
    ops = [o for o in r.ops if r.in_plan(o)]
    if not ops or not r.steps:
        return None
    return r.sum_ms(ops) / r.steps
