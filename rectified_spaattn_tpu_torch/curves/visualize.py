"""Curve visualization (port of rectified_spaattn_tpu/curves/visualize.py;
a debug aid, reference: utils/jenga_gilbert.py:784-922).

matplotlib-gated: returns the figure (or saves it) when matplotlib is
installed, raises a clear ImportError otherwise.
"""

from __future__ import annotations

from . import gilbert


def _pyplot():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("curve visualization needs matplotlib") from e
    return plt


def _coords(t: int, h: int, w: int, variant: str):
    """(x, y, z) of the curve's tokens, in curve order."""
    if variant == "full":
        _, h2l = gilbert.gilbert_mapping(t, h, w)
    elif variant == "sliced":
        _, h2l = gilbert.sliced_gilbert_mapping(t, h, w)
    else:
        raise ValueError(variant)
    return h2l % w, (h2l % (h * w)) // w, h2l // (h * w)


def _finish(plt, fig, save_path):
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
        return save_path
    return fig


def plot_curve(t: int, h: int, w: int, variant: str = "full",
               save_path: str | None = None):
    """3-D line plot of the curve through the (t,h,w) grid."""
    plt = _pyplot()
    x, y, z = _coords(t, h, w, variant)
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(x, y, z, "b-", linewidth=0.8)
    ax.scatter(x, y, z, c="r", s=6)
    ax.set_title(f"{variant} Gilbert curve ({w}x{h}x{t})")
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.view_init(elev=20, azim=45)
    return _finish(plt, fig, save_path)


def plot_comparison(t: int, h: int, w: int, save_path: str | None = None):
    """Side-by-side full vs sliced curves (reference:
    visualize_gilbert_curves_comparison)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(16, 7))
    for i, variant in enumerate(("full", "sliced")):
        x, y, z = _coords(t, h, w, variant)
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.plot(x, y, z, "b-", linewidth=0.8)
        ax.set_title(f"{variant} ({w}x{h}x{t})")
    return _finish(plt, fig, save_path)
