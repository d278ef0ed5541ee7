"""plan_launches: device operations (kernels, copies, memsets) queued per
step inside the benchmark's host range around ``build_sparse_plan``."""


def read(r):
    n = sum(1 for o in r.ops if r.in_plan(o))
    if not n or not r.steps:
        return None
    return n / r.steps
