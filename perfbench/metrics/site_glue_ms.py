"""site_glue_ms: device ms per step of the operations whose innermost
program range is ``rsa.site`` itself: what the sparse site launches
outside its plan, grouping, kernels, rectification and text rows (the
pad inserts, validity zeroing, the KV pack, the text join, the pad
removal)."""

from perfbench.spans import SITE, enclosing, ranges


def read(r):
    if not ranges(r, SITE) or not r.steps:
        return None
    ops = [o for o, names in zip(r.ops, enclosing(r))
           if names and names[-1] == SITE]
    return r.sum_ms(ops) / r.steps
