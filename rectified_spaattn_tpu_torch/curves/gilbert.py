"""Generalized Hilbert ("Gilbert") space-filling curves for arbitrary 3-D grids.

Copy of rectified_spaattn_tpu/curves/gilbert.py for the PyTorch port (the
port imports nothing of the JAX package).  Rebuild of the reference Jenga
token-reorder stage
(reference: utils/jenga_gilbert.py:12-504).  Instead of the reference's
per-point recursive index lookup (O(N log N) Python calls, minutes at video
scale), we *walk* the curve once with an explicit stack and vectorized run
emission (O(N), seconds), producing identical orderings.

The curve maps spatio-temporally adjacent latent tokens into the same
128-token block so that dynamic block-sparse attention captures local
structure.  All outputs are host-side NumPy index arrays; on device they are
applied with a single gather (`torch.index_select`).

Conventions (match the reference exactly):
  - grid is (t, h, w); linear index = z*h*w + y*w + x  with x in [0,w)
  - ``axis_order`` names the (major, mid, minor) traversal axes out of
    {"w","h","t"}; drivers use ("w","h","t")
  - ``linear_to_hilbert[linear] = curve position``;
    ``hilbert_to_linear[pos] = linear``  (a permutation pair)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gilbert3d_path",
    "gilbert_mapping",
    "sliced_gilbert_mapping",
    "gilbert_block_neighbor_mask",
    "sliced_gilbert_block_neighbor_mask",
    "block_wise_mapping",
]


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

    # Native fast path (csrc/gilbert.cpp, ~40x): identical splitting rules.
    from . import native
    if native.available():
        path = native.gilbert3d_path(width, height, depth, axis_order)
        if path is not None:
            return path

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


def _path_to_mappings(path: np.ndarray, t: int, h: int, w: int):
    """Convert a curve walk into (linear_to_hilbert, hilbert_to_linear)."""
    linear_of_pos = (path[:, 2] * (h * w) + path[:, 1] * w + path[:, 0])
    hilbert_to_linear = linear_of_pos.astype(np.int64)
    linear_to_hilbert = np.empty_like(hilbert_to_linear)
    linear_to_hilbert[hilbert_to_linear] = np.arange(
        hilbert_to_linear.shape[0], dtype=np.int64)
    return linear_to_hilbert, hilbert_to_linear


def gilbert_mapping(t: int, h: int, w: int,
                    axis_order: tuple | None = ("w", "h", "t")):
    """Full-grid Gilbert mapping (reference: utils/jenga_gilbert.py:458-504).

    Returns (linear_to_hilbert, hilbert_to_linear) int64 arrays of length
    t*h*w.  Apply ``tokens[hilbert_to_linear]`` to permute a linear token
    sequence into curve order and ``tokens[linear_to_hilbert]`` to undo it.
    """
    path = gilbert3d_path(w, h, t, axis_order=axis_order)
    return _path_to_mappings(path, t, h, w)


def sliced_gilbert_mapping(t: int, h: int, w: int):
    """Per-frame 2-D Gilbert curves chained across time
    (reference: utils/jenga_gilbert.py:348-456).

    Each time slice is filled with a 2-D curve; successive slices are
    flipped so the chain continues from the corner nearest to where the
    previous slice ended.
    """
    total = t * h * w
    linear_to_hilbert = np.empty(total, dtype=np.int64)
    hilbert_to_linear = np.empty(total, dtype=np.int64)

    # One slice's 2-D curve (d == 1, default size-based axis order).
    path2d = gilbert3d_path(w, h, 1, axis_order=None)
    slice_l2h = np.empty(h * w, dtype=np.int64)
    slice_l2h[path2d[:, 1] * w + path2d[:, 0]] = np.arange(h * w)

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base_linear = (yy * w + xx).ravel()

    last_end = None
    offset = 0
    for z in range(t):
        if last_end is None:
            flip_x = flip_y = False
        else:
            ex, ey = last_end
            flip_x = ex >= w / 2
            flip_y = ey >= h / 2
        ax = (w - 1 - xx) if flip_x else xx
        ay = (h - 1 - yy) if flip_y else yy
        hil = slice_l2h[(ay * w + ax).ravel()]
        lin = z * h * w + base_linear
        linear_to_hilbert[lin] = offset + hil
        hilbert_to_linear[offset + hil] = lin
        # Where does this slice's curve end (in actual, flipped coords)?
        end_local = hilbert_to_linear[offset + h * w - 1] - z * h * w
        last_end = (end_local % w, end_local // w)
        offset += h * w
    return linear_to_hilbert, hilbert_to_linear


def _neighbor_mask_from_colors(colors: np.ndarray, num_blocks: int) -> np.ndarray:
    """26-neighborhood block adjacency from a (t, h, w) block-color map.

    Vectorized over the 26 axis shifts instead of the reference's triple
    Python loop (reference: utils/jenga_gilbert.py:648-693).
    """
    from . import native
    if native.available():
        adj_n = native.block_neighbors(colors, num_blocks)
        if adj_n is not None:
            return adj_n

    adj = np.zeros((num_blocks, num_blocks), dtype=bool)
    idx = np.arange(num_blocks)
    adj[idx, idx] = True
    t, h, w = colors.shape
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                zs = slice(max(dz, 0), t + min(dz, 0))
                ys = slice(max(dy, 0), h + min(dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                zd = slice(max(-dz, 0), t + min(-dz, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                a = colors[zs, ys, xs].ravel()
                b = colors[zd, yd, xd].ravel()
                adj[a, b] = True
    return adj


def gilbert_block_neighbor_mask(t: int, h: int, w: int, block_size: int = 128,
                                axis_order: tuple | None = ("w", "h", "t")
                                ) -> np.ndarray:
    """[NB, NB] bool adjacency of 128-token curve blocks under the full-grid
    curve (reference: utils/jenga_gilbert.py:613-693).  A True at (i, j)
    means key-block j is physically 26-adjacent to some voxel of
    query-block i and is force-included in the sparse mask.
    """
    total = t * h * w
    num_blocks = (total + block_size - 1) // block_size
    l2h, _ = gilbert_mapping(t, h, w, axis_order=axis_order)
    colors = (l2h // block_size).reshape(t, h, w)
    return _neighbor_mask_from_colors(colors, num_blocks)


def sliced_gilbert_block_neighbor_mask(t: int, h: int, w: int,
                                       block_size: int = 128) -> np.ndarray:
    """Block adjacency under the sliced (per-frame) curve
    (reference: utils/jenga_gilbert.py:695-782)."""
    total = t * h * w
    num_blocks = (total + block_size - 1) // block_size
    l2h, _ = sliced_gilbert_mapping(t, h, w)
    colors = (l2h // block_size).reshape(t, h, w)
    return _neighbor_mask_from_colors(colors, num_blocks)


def block_wise_mapping(t: int, h: int, w: int, block_size=(4, 4, 8)):
    """Fixed-cuboid blocking of the 3-D grid
    (reference: utils/jenga_gilbert.py:506-611; unused by the drivers but
    part of the public surface).

    Returns (linear_to_block, block_start_linear) where ``linear_to_block``
    assigns every voxel its row-major block id and ``block_start_linear``
    holds the linear index of each block's origin voxel.
    """
    bt, bh, bw = block_size
    nt, nh, nw = -(-t // bt), -(-h // bh), -(-w // bw)
    zz, yy, xx = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    block_id = ((zz // bt) * nh * nw + (yy // bh) * nw + (xx // bw)).ravel()
    bz, by, bx = np.meshgrid(np.arange(nt), np.arange(nh), np.arange(nw),
                             indexing="ij")
    block_start = (bz * bt) * h * w + (by * bh) * w + (bx * bw)
    return block_id.astype(np.int64), block_start.ravel().astype(np.int64)
