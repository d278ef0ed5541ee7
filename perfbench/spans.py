"""The program's own host ranges in a traced window's ``Reading``.

The port opens ``rsa.*`` ranges while a torch profiler records
(rectified_spaattn_tpu_torch/utils/timing.py::span): ``rsa.step`` around
each denoise step, ``rsa.site`` around the sparse attention site with
``rsa.plan``, ``rsa.group``, ``rsa.attn``, ``rsa.rectify`` and
``rsa.text`` inside it, and ``rsa.sync.<where>`` around each readback
that waits for the device.  ``trace.read`` keeps them in ``Reading.host``
with the host's other ops.  A device operation belongs to the ranges
whose host interval holds its launch (``Op.launch``, the runtime call
that queued it); gaps are measured between device times alone, so the
host's and the device's clocks are never compared.  A reading of a
program without these ranges gives no ranges, and the readers ``None``.
"""

from __future__ import annotations

import bisect

PREFIX = "rsa."
SITE = "rsa.site"
SYNC = "rsa.sync."


def ranges(r, prefix: str = PREFIX) -> list:
    """[(start ns, end ns, name)] of the host ranges named ``prefix...``,
    by start."""
    return [h for h in r.host if h[2].startswith(prefix)]


def enclosing(r) -> list:
    """Per operation of ``r.ops``, the names of the ``rsa.*`` ranges that
    hold its launch, outermost first (ranges of one thread nest)."""
    marks = sorted(ranges(r), key=lambda h: (h[0], -h[1]))
    out = [()] * len(r.ops)
    stack, j = [], 0
    for i in sorted(range(len(r.ops)), key=lambda i: r.ops[i].launch):
        t = r.ops[i].launch
        if t < 0:                     # no runtime call matched: no range
            continue
        while j < len(marks) and marks[j][0] <= t:
            while stack and stack[-1][1] < marks[j][0]:
                stack.pop()
            stack.append(marks[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(h[2] for h in stack)
    return out


def idle_gaps(r) -> dict:
    """{index in ``r.ops``: idle ns before it} for each operation that
    starts after every operation started before it has ended: the gaps
    between the busy intervals of ``trace.merged``, each keyed by the
    operation that ends it."""
    out, end = {}, None
    for i, o in enumerate(r.ops):
        if end is not None and o.start > end:
            out[i] = o.start - end
        end = o.start + o.dur if end is None else max(end, o.start + o.dur)
    return out


def after_syncs(r) -> set:
    """Indices in ``r.ops`` of the first operation launched after each
    ``rsa.sync.*`` range ends, each once."""
    launched = sorted((o.launch, i) for i, o in enumerate(r.ops)
                      if o.launch >= 0)
    times = [t for t, _ in launched]
    out = set()
    for _, end, _ in ranges(r, SYNC):
        k = bisect.bisect_right(times, end)
        if k < len(launched):
            out.add(launched[k][1])
    return out
