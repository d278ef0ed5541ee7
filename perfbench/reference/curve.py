"""The curve order and the block neighbours, worked out again for the
yardstick: a frozen copy of the port's pure-Python Gilbert walker
(rectified_spaattn_tpu_torch/curves/gilbert.py:36-175, without its native
fast path) and of its 26-neighbourhood block adjacency (:233-280, the
NumPy loop).  The benchmark compares the program's permutation and
neighbour mask with these, entry by entry."""

from __future__ import annotations

import numpy as np


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def _sgn3(v):
    return (_sgn(v[0]), _sgn(v[1]), _sgn(v[2]))


def _norm(v) -> int:
    return abs(v[0] + v[1] + v[2])


def _halve(v):
    return (v[0] // 2, v[1] // 2, v[2] // 2)


def _add(u, v):
    return (u[0] + v[0], u[1] + v[1], u[2] + v[2])


def _sub(u, v):
    return (u[0] - v[0], u[1] - v[1], u[2] - v[2])


def _neg(v):
    return (-v[0], -v[1], -v[2])


def gilbert3d_path(width: int, height: int, depth: int,
                   axis_order: tuple | None = None) -> np.ndarray:
    """Walk the generalized Hilbert curve over a (width x height x depth) grid.

    Returns an int64 array of shape [width*height*depth, 3] holding (x, y, z)
    coordinates in curve order.  ``axis_order`` is a permutation of
    ("w","h","t") choosing the (major, mid, minor) axes; None reproduces the
    size-based default of the classic algorithm.
    """
    total = width * height * depth
    if total == 0:
        return np.zeros((0, 3), dtype=np.int64)

    axes = {
        "w": (width, 0, 0),
        "h": (0, height, 0),
        "t": (0, 0, depth),
    }
    if axis_order is not None:
        a0 = axes[axis_order[0]]
        b0 = axes[axis_order[1]]
        c0 = axes[axis_order[2]]
    else:
        if width >= height and width >= depth:
            a0, b0, c0 = axes["w"], axes["h"], axes["t"]
        elif height >= width and height >= depth:
            a0, b0, c0 = axes["h"], axes["w"], axes["t"]
        else:
            a0, b0, c0 = axes["t"], axes["w"], axes["h"]

    out = np.empty((total, 3), dtype=np.int64)
    pos = 0
    # Explicit stack of (origin, a, b, c) cuboids, traversed depth-first in
    # curve order (children pushed in reverse).
    stack = [((0, 0, 0), a0, b0, c0)]
    arange_cache: dict[int, np.ndarray] = {}

    while stack:
        (x, a, b, c) = stack.pop()
        w, h, d = _norm(a), _norm(b), _norm(c)
        da, db, dc = _sgn3(a), _sgn3(b), _sgn3(c)

        # Trivial runs: one free axis left -> emit the whole row vectorized.
        run = None
        if h == 1 and d == 1:
            run, dv = w, da
        elif w == 1 and d == 1:
            run, dv = h, db
        elif w == 1 and h == 1:
            run, dv = d, dc
        if run is not None:
            idx = arange_cache.get(run)
            if idx is None:
                idx = np.arange(run, dtype=np.int64)
                arange_cache[run] = idx
            out[pos:pos + run, 0] = x[0] + idx * dv[0]
            out[pos:pos + run, 1] = x[1] + idx * dv[1]
            out[pos:pos + run, 2] = x[2] + idx * dv[2]
            pos += run
            continue

        a2, b2, c2 = _halve(a), _halve(b), _halve(c)
        w2, h2, d2 = _norm(a2), _norm(b2), _norm(c2)
        # Prefer even-length splits so sub-blocks stay well-formed.
        if (w2 % 2) and (w > 2):
            a2 = _add(a2, da)
        if (h2 % 2) and (h > 2):
            b2 = _add(b2, db)
        if (d2 % 2) and (d > 2):
            c2 = _add(c2, dc)

        if (2 * w > 3 * h) and (2 * w > 3 * d):
            # Wide case: split along the major axis only.
            children = [
                (x, a2, b, c),
                (_add(x, a2), _sub(a, a2), b, c),
            ]
        elif 3 * h > 4 * d:
            # Flat-in-d case: 3-way split, don't split the minor axis.
            children = [
                (x, b2, c, a2),
                (_add(x, b2), a, _sub(b, b2), c),
                (_add(_add(x, _sub(a, da)), _sub(b2, db)),
                 _neg(b2), c, _neg(_sub(a, a2))),
            ]
        elif 3 * d > 4 * h:
            # Flat-in-h case: 3-way split, don't split the mid axis.
            children = [
                (x, c2, a2, b),
                (_add(x, c2), a, b, _sub(c, c2)),
                (_add(_add(x, _sub(a, da)), _sub(c2, dc)),
                 _neg(c2), _neg(_sub(a, a2)), b),
            ]
        else:
            # Regular case: split all three axes into 5 sub-cuboids.
            children = [
                (x, b2, c2, a2),
                (_add(x, b2), c, a2, _sub(b, b2)),
                (_add(_add(x, _sub(b2, db)), _sub(c, dc)),
                 a, _neg(b2), _neg(_sub(c, c2))),
                (_add(_add(_add(x, _sub(a, da)), b2), _sub(c, dc)),
                 _neg(c), _neg(_sub(a, a2)), _sub(b, b2)),
                (_add(_add(x, _sub(a, da)), _sub(b2, db)),
                 _neg(b2), c2, _neg(_sub(a, a2))),
            ]
        stack.extend(reversed(children))

    return out


def gilbert_mapping(t: int, h: int, w: int, axis_order=("w", "h", "t")):
    """(linear_to_curve, curve_to_linear) int64 for a (t, h, w) grid, the
    linear index z*h*w + y*w + x."""
    path = gilbert3d_path(w, h, t, axis_order=axis_order)
    curve_to_linear = path[:, 2] * (h * w) + path[:, 1] * w + path[:, 0]
    linear_to_curve = np.empty_like(curve_to_linear)
    linear_to_curve[curve_to_linear] = np.arange(curve_to_linear.shape[0])
    return linear_to_curve, curve_to_linear


def block_neighbors(linear_to_curve: np.ndarray, t: int, h: int, w: int,
                    block: int = 128) -> np.ndarray:
    """[NB, NB] bool: key block j is 26-adjacent to a voxel of query
    block i (the diagonal included)."""
    nb = -(-t * h * w // block)
    colors = (linear_to_curve // block).reshape(t, h, w)
    adj = np.zeros((nb, nb), dtype=bool)
    adj[np.arange(nb), np.arange(nb)] = True
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                src = colors[max(dz, 0):t + min(dz, 0),
                             max(dy, 0):h + min(dy, 0),
                             max(dx, 0):w + min(dx, 0)].ravel()
                dst = colors[max(-dz, 0):t + min(-dz, 0),
                             max(-dy, 0):h + min(-dy, 0),
                             max(-dx, 0):w + min(-dx, 0)].ravel()
                adj[src, dst] = True
    return adj
