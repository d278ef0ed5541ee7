"""Operations and bytes of the dense attention calls that the port names
with their sizes while a profiler records (pipelines/wan.py:
``rsa.dense:b=..,h=..,q=..,k=..,d=..`` around each dense self-attention
call of the warm gate, ``rsa.cross:...`` around each cross-attention
call), and their roofline bounds at the card's peaks (perfbench/
peaks.py): both products over every (query, key) pair, q, k and v read
once and the output written once, in bf16.  The sizes are the call's
(the stream padded to a block: at 720p 75,648 rows for 75,600 tokens,
0.06 % more work than the valid tokens need)."""

from __future__ import annotations

from . import peaks
from .spans import enclosing, ranges

DENSE = "rsa.dense"
CROSS = "rsa.cross"


def sizes(name: str):
    """{b, h, q, k, d} from a range name ``<kind>:b=1,h=40,...``, or None
    where the name carries no sizes."""
    _, sep, rest = name.partition(":")
    if not sep:
        return None
    try:
        return {k: int(v) for k, v in
                (kv.split("=") for kv in rest.split(","))}
    except ValueError:
        return None


def call(b: int, h: int, q: int, k: int, d: int, elem: int = 2):
    """(flops, bound seconds) of one dense attention call."""
    flops = 4.0 * b * h * q * k * d
    nbytes = float(elem * b * h * d * (2 * q + 2 * k))
    return flops, peaks.bound_s(flops, nbytes)


def calls(r, kind: str) -> list:
    """[(flops, bound seconds)] of the ``kind`` ranges of a reading that
    carry their sizes."""
    out = []
    for _, _, name in ranges(r, kind + ":"):
        s = sizes(name)
        if s is not None:
            out.append(call(s["b"], s["h"], s["q"], s["k"], s["d"]))
    return out


def launched_in(r, kind: str) -> list:
    """The reading's device operations whose launch lies inside a
    ``kind`` range, at any depth."""
    return [o for o, names in zip(r.ops, enclosing(r))
            if any(n.startswith(kind + ":") for n in names)]


def per_step_ms(r, kind: str):
    """Device ms per step of the operations launched inside ``kind``
    ranges, or None where the reading has none."""
    if not calls(r, kind) or not r.steps:
        return None
    return r.sum_ms(launched_in(r, kind)) / r.steps


def roofline_pct(r, kind: str):
    """The ``kind`` calls' bounds over the device time of the operations
    launched inside them, in %, or None where there is nothing to read."""
    bounds = calls(r, kind)
    seconds = sum(o.dur for o in launched_in(r, kind)) / 1e9
    if not bounds or not seconds:
        return None
    return 100.0 * sum(b for _, b in bounds) / seconds
