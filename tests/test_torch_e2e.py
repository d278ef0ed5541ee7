"""The port's end-to-end benches' weights and its HunyuanVideo and Wan
benches (rectified_spaattn_tpu_torch/bench: e2e_weights, e2e, e2e_wan)
against the JAX scripts of scripts/ (tests/_torch_e2e_common.py):

- the weight pools and the random bf16 / int8 / int4 trees at the tiny
  configs, bit for bit (the scripts' samplers patched to small pools, so
  that the windows wrap);
- smooth_latents' deterministic part against jax.image.resize "linear"
  at fp32 2e-4 / 2e-5;
- ``run(small=True, device="cpu")``'s sparse and flash latents against
  the JAX pipeline at the bench's settings, 1e-3 / 1e-4.
The CogVideoX and Flux benches and the calibration are in
tests/test_torch_e2e_families.py, the fidelity gate, long context and
ab_eval in tests/test_torch_e2e_sites.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_e2e_common import (BYTE_POOL, F32, POOL, TOL, f32_tree,  # noqa
                               noise, script, small_pools,
                               small_port_pools)
from rectified_spaattn_tpu_torch import models as pm
from rectified_spaattn_tpu_torch.bench import e2e_weights as ew
from rectified_spaattn_tpu_torch.models import flax_to_state_dict

torch.set_num_threads(1)


# ------------------------------------------------------------- weights ---

def test_pool_samplers_match_the_scripts():
    """pool_normal_sampler and the byte pool's windows, bit for bit,
    through a wrap of the pool."""
    be = script("bench_e2e")
    want = be.pool_normal_sampler(3, 0.02, pool_bits=POOL)
    got = ew.pool_normal_sampler(3, 0.02, pool_bits=POOL)
    for shape in [(7, 5), (1000,), (3, 1024), (2,), (2500,)]:
        np.testing.assert_array_equal(got(shape).numpy(), want(shape))
    # host_quantized_tree's draw_bytes: the same window rule on the byte
    # pool of default_rng(seed).integers(0, 256, 2^bits, uint8)
    g = np.random.default_rng(5)
    bpool = g.integers(0, 256, size=1 << BYTE_POOL, dtype=np.uint8)
    draw = ew.byte_sampler(5, pool_bits=BYTE_POOL)
    off = 0
    for shape in [(64, 9), (3000,), (2, 2048)]:
        n = int(np.prod(shape))
        idx = (off % bpool.size + np.arange(n)) % bpool.size
        off += n + 9973
        np.testing.assert_array_equal(draw(shape).numpy(),
                                      bpool[idx].reshape(shape))


def _families():
    from rectified_spaattn_tpu.models import cogvideox as jc
    from rectified_spaattn_tpu.models import flux as jf
    from rectified_spaattn_tpu.models import hunyuan as jh
    from rectified_spaattn_tpu.models import wan as jw
    be, bw = script("bench_e2e"), script("bench_e2e_wan")
    bc, bf = script("bench_e2e_cog"), script("bench_e2e_flux")

    def hun():
        jcfg = jh.HunyuanVideoConfig.tiny()
        jm = jh.HunyuanVideoDiT(jcfg)
        return (pm.HunyuanVideoDiT, pm.HunyuanVideoConfig.tiny(),
                lambda: be.host_bf16_params(jm, jcfg, jcfg.text_dim),
                lambda: be.param_shapes(jm, jcfg, jcfg.text_dim))

    def wan(**kw):
        jcfg = jw.WanConfig.tiny(**kw)
        jm = jw.WanDiT(jcfg)
        return (pm.WanDiT, pm.WanConfig.tiny(**kw),
                lambda: bw.host_bf16_params(jm, jcfg),
                lambda: bw.wan_param_shapes(jm, jcfg))

    def cog():
        jcfg = jc.CogVideoXConfig.tiny()
        jm = jc.CogVideoXDiT(jcfg)
        return (pm.CogVideoXDiT, pm.CogVideoXConfig.tiny(),
                lambda: bc.host_bf16_params(jm, jcfg), None)

    def flux():
        jcfg = jf.FluxConfig.tiny()
        jm = jf.FluxDiT(jcfg)
        return (pm.FluxDiT, pm.FluxConfig.tiny(),
                lambda: bf.build_params(jm, jcfg, 0, False),
                lambda: bf.flux_param_shapes(jm, jcfg))

    return {"hunyuan": hun, "wan": wan,
            "wan_i2v": lambda: wan(image_cross=True, in_channels=36),
            "cogvideox": cog, "flux": flux}


def assert_same_tree(flax_tree, model):
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, flax_tree))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.dtype == want[key].dtype, key
        assert torch.equal(t, want[key]), key


@pytest.mark.parametrize("family", ["hunyuan", "wan", "wan_i2v",
                                    "cogvideox", "flux"])
def test_bf16_tree_matches_the_script(family, small_pools):
    """The port's tree drawn leaf by leaf in the Flax order equals the
    script's tree carried across by flax_to_state_dict, bit for bit."""
    cls, cfg, jax_tree, _ = _families()[family]()
    if family == "cogvideox":   # one default_rng(0).normal draw a leaf
        model = ew.random_normal_model(cls, cfg, device="cpu",
                                       dtype=torch.bfloat16)
    else:
        model = ew.random_bf16_model(cls, cfg, device="cpu", pool_bits=POOL,
                                     dtype=torch.bfloat16)
    assert_same_tree(jax_tree(), model)
    assert ew.n_params(cls, cfg) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jax_tree()))


@pytest.mark.parametrize("family", ["hunyuan", "wan_i2v", "flux"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_matches_the_script(family, bits, small_pools):
    """host_quantized_tree's direct int8 / int4 tree (kernels of >= 1,000
    elements quantized, int4 in groups of 32 rows) against the port's
    QLinear layouts, bit for bit, both pools small."""
    cls, cfg, _, shapes = _families()[family]()
    kw = dict(min_size=1000, group_size=32)
    tree = small_pools.host_quantized_tree(shapes(), bits=bits, **kw)
    model = ew.random_quantized_model(cls, cfg, bits, device="cpu",
                                      pool_bits=POOL,
                                      byte_pool_bits=BYTE_POOL,
                                      dtype=torch.bfloat16, **kw)
    layouts = {m.layout for m in model.modules()
               if isinstance(m, pm.QLinear)}
    assert layouts == {"dense", "int8" if bits == 8 else "int4"}
    assert_same_tree(tree, model)


@pytest.mark.parametrize("coarse,size", [((2, 3, 5), (3, 13, 21)),
                                         ((3, 5, 7), (7, 21, 29)),
                                         ((16, 22, 40), (33, 90, 160))])
def test_smooth_latents_resize_matches_jax(coarse, size):
    """The deterministic part of smooth_latents against the script's
    jax.image.resize(..., "linear") on the same numpy noise, odd sizes
    included; and the draw's shapes."""
    g = np.random.default_rng(0)
    c = g.normal(size=(1, 2, *coarse)).astype(np.float32)
    fine = g.normal(size=(1, 2, *size)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(c), (1, 2, *size),
                                       "linear") + 0.5 * jnp.asarray(fine))
    got = ew.smooth_from_noise(torch.from_numpy(c), torch.from_numpy(fine))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    lat = ew.smooth_latents(2, *size, device="cpu")
    assert lat.shape == (1, 2, *size) and torch.isfinite(lat).all()
    torch.testing.assert_close(lat, ew.smooth_latents(2, *size,
                                                      device="cpu"))


# ------------------------------------------------------------- benches ---

def test_hunyuan_bench_matches_jax(small_pools, small_port_pools):
    from rectified_spaattn_tpu.models import hunyuan as jh
    from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JPipe
    from rectified_spaattn_tpu_torch.bench import e2e
    lat = {}
    line = e2e.run(small=True, device="cpu", latents_out=lat)
    s = e2e.SMALL
    assert line["speedup"] == (line["modes"]["flash"]["s_per_step"]
                               / line["modes"]["sparse"]["s_per_step"])
    assert line["tokens"] == 4 * 8 * 16 + 256
    jcfg = jh.HunyuanVideoConfig(
        hidden_dim=s["hidden"], heads=1, num_dual_blocks=1,
        num_single_blocks=1, text_dim=1024, pooled_dim=256,
        num_refiner_blocks=1)
    jm = jh.HunyuanVideoDiT(jcfg)
    params = f32_tree(script("bench_e2e").host_bf16_params(jm, jcfg, 1024))
    text = ew.random_text((1, 256, 1024), 0, "cpu").numpy()
    mask = np.zeros((1, 256), bool)
    mask[:, :40] = True
    init = ew.smooth_latents(16, (s["frame"] - 1) // 4 + 1, s["height"] // 8,
                             s["width"] // 8, device="cpu").numpy()
    for mode in ("sparse", "flash"):
        jp = JPipe(model=jm, params=params, height=s["height"],
                   width=s["width"], frames=s["frame"], num_steps=1,
                   sa_drop_rate=0.8, p_remain_rates=0.3, mode=mode,
                   interpret=True)
        want = np.asarray(jp(jnp.asarray(text), jnp.asarray(mask), seed=1,
                             init_latents=jnp.asarray(init)))
        np.testing.assert_allclose(lat[mode].numpy(), want, **TOL)


def test_wan_bench_matches_jax(small_pools, small_port_pools):
    from rectified_spaattn_tpu.models import wan as jw
    from rectified_spaattn_tpu.pipelines import WanPipeline as JPipe
    from rectified_spaattn_tpu_torch.bench import e2e_wan
    lat = {}
    line = e2e_wan.run(small=True, device="cpu", latents_out=lat)
    h, w, f = e2e_wan.SMALL_VIDEO
    blocks, _ = e2e_wan.SMALL_DEPTH
    assert line["blocks"] == blocks and "speedup" in line
    jcfg = jw.WanConfig(num_blocks=blocks, **e2e_wan.SMALL)
    jm = jw.WanDiT(jcfg)
    params = f32_tree(script("bench_e2e_wan").host_bf16_params(jm, jcfg))
    text = ew.random_text((1, 512, jcfg.text_dim), 0, "cpu").numpy()
    neg = ew.random_text((1, 512, jcfg.text_dim), 1, "cpu").numpy()
    for mode in ("sparse", "flash"):
        jp = JPipe(model=jm, params=params, height=h, width=w, frames=f,
                   num_steps=1, sa_drop_rate=0.75, p_remain_rates=0.05,
                   mode=mode, warm_layers=0, warm_calls=0,
                   vae_stride=(4, 16, 16), interpret=True)
        init = noise((1, 16, *jp.grid))
        want = np.asarray(jp.denoise(*map(jnp.asarray, (init, text, neg))))
        np.testing.assert_allclose(lat[mode].numpy(), want, **TOL)




@pytest.mark.parametrize("name", ["e2e", "e2e_wan", "e2e_cog", "e2e_flux",
                                  "fidelity_gate", "longctx", "ab_eval",
                                  "calibrate_teacache"])
def test_benches_default_to_the_card(name, tmp_path):
    """Without --device every bench asks for the card and raises where
    there is none; nothing runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import importlib
    mod = importlib.import_module(f"rectified_spaattn_tpu_torch.bench.{name}")
    argv = ["--small"] + (["--out", str(tmp_path)]
                          if name == "calibrate_teacache" else [])
    with pytest.raises(RuntimeError, match="CUDA device|device='cpu'"):
        mod.main(argv)
