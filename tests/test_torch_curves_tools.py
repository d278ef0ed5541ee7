"""The port's curve tools against the JAX package on the CPU: ``curves
warm``'s lines for each geometry and variant, its table of token grids
(each derived here from the pipeline that builds it), and the coordinates
that plot_curve and plot_comparison draw.  All exact: the same integers on
both sides."""

import re

import numpy as np
import pytest
import torch

from rectified_spaattn_tpu.curves import __main__ as jwarm
from rectified_spaattn_tpu.curves import cache as jcache
from rectified_spaattn_tpu.curves import visualize as jvis
from rectified_spaattn_tpu_torch.curves import __main__ as warm
from rectified_spaattn_tpu_torch.curves import cache
from rectified_spaattn_tpu_torch.curves import visualize as vis

torch.set_num_threads(1)


def warm_lines(main, argv, capsys):
    """``main(argv)``'s printed lines without their seconds."""
    main(argv)
    return [re.sub(r" \(\d+\.\d+s\)$", "", ln)
            for ln in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("variant", ["full", "sliced", "linear"])
def test_warm_prints_the_lines_of_jax(variant, capsys, tmp_path, monkeypatch):
    """Cold and then warm (read back from the cache): the same lines as
    JAX's CLI, each cache in a directory of the test's own."""
    monkeypatch.setattr(jcache, "_DEFAULT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(cache, "_DEFAULT_DIR", str(tmp_path / "port"))
    argv = ["warm", "--geometries", "2x8x16,3x4x5,1x16x16,4x6x10",
            "--variant", variant, "--block", "64"]
    want = warm_lines(jwarm.main, argv, capsys)
    assert want[0] == "2x8x16: 256 tokens, 4 blocks"
    for _ in range(2):
        assert warm_lines(warm.main, argv, capsys) == want
    cached = sorted(p.name for p in (tmp_path / "port").glob("*.npz")) \
        if variant != "linear" else []
    assert len(cached) == (4 if variant != "linear" else 0)
    with pytest.raises(SystemExit):
        warm.main([])


def test_known_geometries_are_the_pipelines_grids(monkeypatch):
    """Each entry of the port's table is the token grid its pipeline
    builds its sparse site on at that operating point (the pipelines'
    build_site stopped at its call, the models stand-ins with the
    published configs); JAX's table agrees but for its CogVideoX and Flux
    entries, grids no pipeline builds there."""
    import rectified_spaattn_tpu_torch.pipelines.cogvideox as pcog
    import rectified_spaattn_tpu_torch.pipelines.flux as pflux
    import rectified_spaattn_tpu_torch.pipelines.hunyuan as phun
    import rectified_spaattn_tpu_torch.pipelines.wan as pwan
    from rectified_spaattn_tpu_torch.models import (
        CogVideoXConfig, FluxConfig, HunyuanVideoConfig, WanConfig)

    class Built(Exception):
        pass

    def stop(t, h, w, **kw):
        raise Built((t, h, w))

    for mod in (pcog, pflux, phun, pwan):
        monkeypatch.setattr(mod, "build_site", stop)

    class Stub(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.cfg = cfg

    points = {
        "hunyuan-720p-128f": lambda: phun.HunyuanVideoPipeline(
            model=Stub(HunyuanVideoConfig()), height=720, width=1280,
            frames=128, device="cpu"),
        "wan21-720p-81f": lambda: pwan.WanPipeline(
            model=Stub(WanConfig()), height=720, width=1280, frames=81,
            device="cpu"),
        "wan22-ti2v-704p-121f": lambda: pwan.WanPipeline(
            model=Stub(WanConfig()), height=704, width=1280, frames=121,
            vae_stride=(4, 32, 32), device="cpu"),
        "cogvideox-768p-81f": lambda: pcog.CogVideoXPipeline(
            model=Stub(CogVideoXConfig()), height=768, width=1360,
            frames=81, device="cpu"),
        "flux-4096": lambda: pflux.FluxPipeline(
            model=Stub(FluxConfig()), height=4096, width=4096,
            device="cpu"),
    }
    assert set(points) == set(warm.KNOWN_GEOMETRIES) == set(
        jwarm.KNOWN_GEOMETRIES)
    for name, make in points.items():
        with pytest.raises(Built) as got:
            make()
        assert got.value.args[0] == warm.KNOWN_GEOMETRIES[name], name
    assert {n for n, g in jwarm.KNOWN_GEOMETRIES.items()
            if warm.KNOWN_GEOMETRIES[n] != g} == {"cogvideox-768p-81f",
                                                   "flux-4096"}


def drawn(fig):
    """(title, [(x, y, z) of each line], [scatter offsets]) of each axes."""
    out = []
    for ax in fig.axes:
        lines = [np.asarray(ln.get_data_3d()) for ln in ax.lines]
        points = [np.asarray(c._offsets3d) for c in ax.collections]
        out.append((ax.get_title(), lines, points))
    return out


@pytest.mark.parametrize("variant", ["full", "sliced"])
def test_plot_curve_draws_the_coordinates_of_jax(variant, tmp_path):
    import matplotlib.pyplot as plt
    figs = [vis.plot_curve(2, 4, 6, variant),
            jvis.plot_curve(2, 4, 6, variant),
            vis.plot_comparison(3, 4, 4), jvis.plot_comparison(3, 4, 4)]
    try:
        for got, want in ((figs[0], figs[1]), (figs[2], figs[3])):
            got, want = drawn(got), drawn(want)
            assert len(got) == len(want) > 0
            for (t, ls, ps), (jt, jls, jps) in zip(got, want):
                assert t == jt and len(ls) == len(jls) > 0
                for a, b in zip(ls + ps, jls + jps):
                    np.testing.assert_array_equal(a, b)
        assert drawn(figs[0])[0][1][0].shape == (3, 2 * 4 * 6)
    finally:
        for f in figs:
            plt.close(f)
    path = str(tmp_path / "c.png")
    assert vis.plot_curve(2, 4, 6, variant, save_path=path) == path
    assert (tmp_path / "c.png").stat().st_size > 0
    with pytest.raises(ValueError):
        vis.plot_curve(2, 4, 6, "linear")
