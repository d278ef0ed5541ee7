"""sync_idle_ms: device idle ms per step that the program's readbacks
leave.  For each ``rsa.sync.*`` range, the first device operation
launched after the range ends: where it started after every operation
before it had ended, the gap between the latest of those ends and its
start counts (once, where several readbacks precede one operation)."""

from perfbench.spans import SYNC, after_syncs, idle_gaps, ranges


def read(r):
    if not ranges(r, SYNC) or not r.steps:
        return None
    gaps = idle_gaps(r)
    return sum(gaps.get(i, 0) for i in after_syncs(r)) / 1e6 / r.steps
