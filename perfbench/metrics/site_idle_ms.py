"""site_idle_ms: device idle ms per step in the gaps between busy
intervals that end with an operation launched inside ``rsa.site`` at
any depth: the idle that the sparse site's host path leaves (its
readbacks included)."""

from perfbench.spans import SITE, enclosing, idle_gaps, ranges


def read(r):
    if not ranges(r, SITE) or not r.steps:
        return None
    names = enclosing(r)
    gaps = idle_gaps(r)
    return sum(g for i, g in gaps.items() if SITE in names[i]) / 1e6 / r.steps
