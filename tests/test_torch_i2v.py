"""The port's image-to-video path against the JAX package on the CPU: the
per-token two-way modulation (HunyuanVideo I2V token_replace) in the adaLN
norms and the stream blocks, the token_replace DiT, the HunyuanVideo
pipeline under token_replace and latent_concat, the conditioning helpers on
one stand-in VAE encoder, Wan2.2 A14B's two transformers with and without
host_swap, the CLI's I2V / Wan2.2 models and its image loader.  Same numpy
inputs, Flax parameters bridged by models/convert.py; fp32 rtol 1e-3 /
atol 1e-4 (tests/test_models.py:65), the encoder helpers at 2e-4 / 2e-5,
the image loader at 1e-6; held first frames and decisions exact."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import attention as j_attention
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import layers as jl
from rectified_spaattn_tpu.models import vae as jvae
from rectified_spaattn_tpu.models.hunyuan import (
    HunyuanVideoConfig as JHConfig, HunyuanVideoDiT as JHDiT)
from rectified_spaattn_tpu.models.wan import (WanConfig as JWConfig,
                                              WanDiT as JWDiT)
from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JHPipe
from rectified_spaattn_tpu.pipelines import Wan22A14BPipeline as JA14B
from rectified_spaattn_tpu.pipelines import WanPipeline as JWPipe
from rectified_spaattn_tpu.pipelines import hunyuan as jph
from rectified_spaattn_tpu.pipelines import wan as jpw
from rectified_spaattn_tpu_torch.attention import attention
from rectified_spaattn_tpu_torch.models import (
    HunyuanVideoConfig, HunyuanVideoDiT, VAEConfig, VAEEncoder, WanConfig,
    WanDiT, layers, load_flax_params)
from rectified_spaattn_tpu_torch.pipelines import (
    HunyuanVideoPipeline, Wan22A14BPipeline, WanPipeline,
    i2v_condition, i2v_condition_concat, i2v_first_frame, ti2v_first_frame)

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-4)
ENC_TOL = dict(rtol=2e-4, atol=2e-5)
DIM, HEADS = 64, 2


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def vanilla_pair():
    return (lambda q, k, v: j_attention(q, k, v, mode="vanilla"),
            lambda q, k, v: attention(q, k, v, mode="vanilla"))


def alt_mask(n, seed=0):
    """A scattered boolean mask, as the curve scatters the first frame."""
    m = np.random.default_rng(seed).random(n) < 0.4
    m[0], m[-1] = True, False
    return m


def test_select_mods():
    mods = tuple(arr(i, 2, 1, DIM) for i in range(3))
    alts = tuple(arr(10 + i, 2, 1, DIM) for i in range(3))
    mask = alt_mask(7)
    want = jl._select_mods(tuple(map(jnp.asarray, mods)),
                           tuple(map(jnp.asarray, alts)), jnp.asarray(mask))
    got = layers._select_mods(tuple(map(t, mods)), tuple(map(t, alts)),
                              t(mask))
    for g, w in zip(got, want):
        assert g.shape == (2, 7, DIM)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert layers._select_mods(mods, None, None) is mods


@pytest.mark.parametrize("name", ["zero", "single", "continuous"])
def test_ada_layer_norms_with_alt(name):
    jcls, tcls = {"zero": (jl.AdaLayerNormZero, layers.AdaLayerNormZero),
                  "single": (jl.AdaLayerNormZeroSingle,
                             layers.AdaLayerNormZeroSingle),
                  "continuous": (jl.AdaLayerNormContinuous,
                                 layers.AdaLayerNormContinuous)}[name]
    x, emb, alt = arr(2, 2, 7, DIM), arr(3, 2, DIM), arr(4, 2, DIM)
    mask = alt_mask(7)
    jmod, tmod = jcls(DIM), tcls(DIM)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), x, emb, alt, mask))
    load_flax_params(tmod, params)
    want = jmod.apply(params, x, emb, alt, mask)
    with torch.no_grad():
        got = tmod(t(x), t(emb), t(alt), t(mask))
        plain = tmod(t(x), t(emb))
    wrap = lambda o: o if isinstance(o, tuple) else (o,)
    for g, w, p in zip(wrap(got), wrap(want), wrap(plain)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        if g.shape[1] == 7:                  # per token: the unmasked rows
            np.testing.assert_array_equal(g[:, ~mask].numpy(),
                                          p.expand_as(g)[:, ~mask].numpy())


@pytest.mark.parametrize("kind", ["dual", "single"])
def test_stream_blocks_with_alt(kind):
    """temb_alt on the visual tokens under a scattered mask; the single
    block's text tail keeps the step conditioning."""
    jf, tf = vanilla_pair()
    sv = 9
    cos, sin = arr(6, sv, DIM // HEADS // 2), arr(7, sv, DIM // HEADS // 2)
    x, ctx = arr(10, 2, sv, DIM), arr(11, 2, 4, DIM)
    temb, alt = arr(12, 2, DIM), arr(13, 2, DIM)
    mask = alt_mask(sv, 1)
    jcls, tcls = ((jl.DualStreamBlock, layers.DualStreamBlock)
                  if kind == "dual" else
                  (jl.SingleStreamBlock, layers.SingleStreamBlock))
    jmod, tmod = jcls(DIM, HEADS, 4.0), tcls(DIM, HEADS, 4.0)
    jr = (jnp.asarray(cos), jnp.asarray(sin))
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), x, ctx, temb, jr, jf, alt, mask))
    load_flax_params(tmod, params)
    want = jmod.apply(params, x, ctx, temb, jr, jf, alt, mask)
    with torch.no_grad():
        got = tmod(t(x), t(ctx), t(temb), (t(cos), t(sin)), tf, t(alt),
                   t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def hunyuan_pair(image_condition_type="token_replace", in_channels=4):
    jcfg = dataclasses.replace(JHConfig.tiny(), in_channels=in_channels,
                               image_condition_type=image_condition_type)
    g = np.random.default_rng(0)
    text = g.normal(size=(1, 128, jcfg.text_dim)).astype(np.float32)
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    jmod = JHDiT(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, in_channels, 2, 8, 8)),
        jnp.array([0.0]), jnp.asarray(text), jnp.asarray(mask),
        jnp.array([6000.0]), None, None))
    cfg = dataclasses.replace(HunyuanVideoConfig.tiny(),
                              in_channels=in_channels,
                              image_condition_type=image_condition_type)
    tmod = load_flax_params(HunyuanVideoDiT(cfg), params)
    return jmod, params, tmod, text, mask


PIPE_KW = dict(height=64, width=128, frames=8, sa_drop_rate=0.5,
               p_remain_rates=0.5, text_len=128)


@pytest.mark.parametrize("mode", ["vanilla", "sparse"])
def test_token_replace_dit_matches_jax(mode):
    """embed -> run_blocks (curve-order mask) -> head (linear-order mask)
    with the t=0 conditioning of token_replace_temb."""
    jmod, params, tmod, text, mask = hunyuan_pair()
    jpipe = JHPipe(model=jmod, params=params, interpret=True, num_steps=1,
                   mode=mode, **PIPE_KW)
    pipe = HunyuanVideoPipeline(model=tmod, device="cpu", num_steps=1,
                                mode=mode, **PIPE_KW)
    np.testing.assert_array_equal(pipe._ff_mask_curve.numpy(),
                                  np.asarray(jpipe._ff_mask_curve))
    np.testing.assert_array_equal(pipe._ff_mask_linear.numpy(),
                                  np.asarray(jpipe._ff_mask_linear))
    assert 0 < int(pipe._ff_mask_curve.sum()) < pipe._ff_mask_curve.numel()
    lat = arr(3, 1, 4, *pipe.grid)
    ts, guid = np.array([500.0], np.float32), np.array([6e3], np.float32)
    tlen = np.array([9], np.int32)
    args = (text, mask, guid)
    jf = jpipe.site.attn_fn(mode, text_len_rt=jnp.asarray(tlen),
                            interpret=True)
    tf = pipe.site.attn_fn(mode, text_len_rt=t(tlen))
    jx, jctx, jtemb, jrope = jmod.apply(
        params, jnp.asarray(lat), jnp.asarray(ts), *map(jnp.asarray, args),
        jpipe.h2l, method=JHDiT.embed)
    jtr = jmod.apply(params, *map(jnp.asarray, args),
                     method=JHDiT.token_replace_temb)
    jx, _ = jmod.apply(params, jx, jctx, jtemb, jrope, jf, jtr,
                       jpipe._ff_mask_curve, method=JHDiT.run_blocks)
    want = jmod.apply(params, jx, jtemb, jpipe.l2h, *jpipe.grid, jtr,
                      jpipe._ff_mask_linear, method=JHDiT.head)
    with torch.no_grad():
        x, ctx, temb, rope = tmod.embed(t(lat), t(ts), *map(t, args),
                                        pipe.h2l)
        tr = tmod.token_replace_temb(*map(t, args))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), **TOL)
        x, _ = tmod.run_blocks(x, ctx, temb, rope, tf, tr,
                               pipe._ff_mask_curve)
        got = tmod.head(x, temb, pipe.l2h, *pipe.grid, tr,
                        pipe._ff_mask_linear)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_token_replace_select_is_noop_when_embs_equal():
    """With temb_alt equal to temb the select is the plain path bit for
    bit (run_blocks and head); a different alt moves only the first
    frame (tests/test_pipelines.py:589)."""
    _, _, tmod, text, mask = hunyuan_pair()
    pipe = HunyuanVideoPipeline(model=tmod, device="cpu", num_steps=1,
                                mode="vanilla", **PIPE_KW)
    fn = pipe.site.attn_fn("vanilla")
    args = (t(text), t(mask), torch.tensor([6e3]))
    with torch.no_grad():
        x, ctx, temb, rope = tmod.embed(t(arr(2, 1, 4, *pipe.grid)),
                                        torch.tensor([500.0]), *args,
                                        pipe.h2l)
        plain = tmod.run_blocks(x, ctx, temb, rope, fn)
        sel = tmod.run_blocks(x, ctx, temb, rope, fn, temb,
                              pipe._ff_mask_curve)
        torch.testing.assert_close(plain[0], sel[0], rtol=0, atol=0)
        h_plain = tmod.head(plain[0], temb, pipe.l2h, *pipe.grid)
        h_sel = tmod.head(plain[0], temb, pipe.l2h, *pipe.grid, temb,
                          pipe._ff_mask_linear)
        torch.testing.assert_close(h_plain, h_sel, rtol=0, atol=0)
        h_tr = tmod.head(plain[0], temb, pipe.l2h, *pipe.grid,
                         tmod.token_replace_temb(*args),
                         pipe._ff_mask_linear)
    diff = (h_tr - h_plain).abs()
    assert diff[:, :, :1].max() > 1e-6
    assert diff[:, :, 1:].max() == 0


def test_hunyuan_token_replace_pipeline_matches_jax(tmp_path):
    """3 sparse steps with TeaCache (a skip included), K2 at group_rows 2:
    decisions equal JAX's call for call, latents within 1e-3 / 1e-4, the
    first frame held bit for bit."""
    jmod, params, tmod, text, mask = hunyuan_pair()
    kw = dict(num_steps=3, mode="sparse", enable_teacache=True,
              rel_l1_thresh=0.8, group_rows=2, **PIPE_KW)
    jpipe = JHPipe(model=jmod, params=params, interpret=True, **kw)
    pipe = HunyuanVideoPipeline(model=tmod, device="cpu", **kw)
    g = np.random.default_rng(4)
    init = g.normal(size=(1, 4, *pipe.grid)).astype(np.float32)
    first = g.normal(size=(1, 4, 1, *pipe.grid[1:])).astype(np.float32)
    trace = tmp_path / "trace.json"
    with jtc.trace_to(str(trace)):
        want = np.asarray(jpipe(jnp.asarray(text), jnp.asarray(mask),
                                init_latents=jnp.asarray(init),
                                first_frame=jnp.asarray(first)))
    jdec = [r["compute"] for r in json.loads(trace.read_text())
            if "call" in r]
    got = pipe(text, mask, init_latents=init, first_frame=first).numpy()
    assert pipe.teacache.decisions == jdec and False in jdec
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[:, :, :1], first)
    np.testing.assert_array_equal(want[:, :, :1], first)


def test_hunyuan_latent_concat_pipeline_matches_jax():
    """latent_concat (in_channels 9 = 4 noise + 4 latents + 1 mask): the
    condition concatenated at every call; the noise drawn with
    out_channels channels."""
    jmod, params, tmod, text, mask = hunyuan_pair("latent_concat", 9)
    kw = dict(num_steps=2, mode="vanilla", **PIPE_KW)
    jpipe = JHPipe(model=jmod, params=params, interpret=True, **kw)
    pipe = HunyuanVideoPipeline(model=tmod, device="cpu", **kw)
    g = np.random.default_rng(5)
    init = g.normal(size=(1, 4, *pipe.grid)).astype(np.float32)
    cond = g.normal(size=(1, 5, *pipe.grid)).astype(np.float32)
    want = np.asarray(jpipe(jnp.asarray(text), jnp.asarray(mask),
                            init_latents=jnp.asarray(init),
                            condition=jnp.asarray(cond)))
    got = pipe(text, mask, init_latents=init, condition=cond).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    drawn = pipe(text, mask, seed=1, num_steps=1, condition=cond)
    assert drawn.shape == (1, 4, *pipe.grid)


def encoder_pair():
    """The tiny video VAE encoder (2x temporal, 2x spatial) of both
    packages with the same weights: the stand-in vae_encode."""
    kw = dict(video=True)                  # 4 latent channels
    jenc = jvae.VAEEncoder(jvae.VAEConfig.tiny(**kw))
    params = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 3, 5, 16, 16))))
    tenc = load_flax_params(VAEEncoder(VAEConfig.tiny(**kw)), params)
    return lambda v: jenc.apply(params, v), tenc


@pytest.mark.parametrize("helper", ["i2v_condition_concat", "i2v_condition",
                                    "i2v_first_frame", "ti2v_first_frame"])
def test_condition_helpers_match_jax(helper):
    jenc, tenc = encoder_pair()
    img = arr(8, 1, 3, 16, 16)
    frames, lt = 5, 3                  # the tiny encoder: 2t - 1 -> t
    if helper in ("i2v_condition_concat", "i2v_condition"):
        jfn, tfn = ((jph.i2v_condition_concat, i2v_condition_concat)
                    if helper == "i2v_condition_concat"
                    else (jpw.i2v_condition, i2v_condition))
        want = jfn(jnp.asarray(img), frames, jenc, lt)
        with torch.no_grad():
            got = tfn(t(img), frames, tenc, lt)
        n_mask = 1 if helper == "i2v_condition_concat" else 4
        assert got.shape == (1, 4 + n_mask, lt, 8, 8)
    else:
        jfn, tfn = ((jph.i2v_first_frame, i2v_first_frame)
                    if helper == "i2v_first_frame"
                    else (jpw.ti2v_first_frame, ti2v_first_frame))
        want = jfn(jnp.asarray(img), jenc)
        with torch.no_grad():
            got = tfn(t(img), tenc)
        assert got.shape == (1, 4, 1, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


def wan_trees(in_channels=4):
    jcfg = JWConfig.tiny(in_channels=in_channels)
    jmod = JWDiT(jcfg)
    text = arr(6, 1, 16, jcfg.text_dim)
    lat0 = np.zeros((1, in_channels, 2, 4, 4), np.float32)
    trees = [jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(seed), lat0, np.zeros((1,), np.float32), text))
        for seed in (6, 7)]
    return jmod, trees, text


A14B_KW = dict(height=64, width=64, frames=5, num_steps=4, sa_drop_rate=0.5,
               mode="vanilla", scheduler="euler")


def port_a14b(trees, in_channels=4, host_swap=False, kw=A14B_KW):
    pipes = []
    for p in trees:
        model = load_flax_params(WanDiT(WanConfig.tiny(
            in_channels=in_channels)), p)
        model.text_embedder.act = torch.nn.functional.gelu  # JAX's form
        pipes.append(WanPipeline(model=model, device="cpu",
                                 defer_device=host_swap, **kw))
    return Wan22A14BPipeline(high=pipes[0], low=pipes[1],
                             boundary_ratio=0.7, host_swap=host_swap)


@pytest.mark.parametrize("variant", ["t2v", "i2v_condition"])
def test_wan22_a14b_matches_jax_and_host_swap(variant):
    """Boundary 0.7 over 4 Euler steps at shift 5 ([1000, 937, 833, 625]):
    the low tree runs the last step.  Equal to JAX at 1e-3 / 1e-4; the
    routing reaches the low tree; host_swap equals the co-resident run bit
    for bit, twice in a row (the second call re-places the high tree)."""
    in_ch = 4 if variant == "t2v" else 4 + 4 + 4
    jmod, trees, text_c = wan_trees(in_ch)
    text_u = np.zeros_like(text_c)
    cond = (arr(9, 1, 8, 2, 8, 8) if variant == "i2v_condition" else None)
    jpipes = [JWPipe(model=jmod, params=p, interpret=True, **A14B_KW)
              for p in trees]
    jpipe = JA14B(high=jpipes[0], low=jpipes[1], boundary_ratio=0.7)
    lat = arr(10, 1, 4, *jpipe.high.grid)
    want = np.asarray(jpipe.denoise(
        jnp.asarray(lat), jnp.asarray(text_c), jnp.asarray(text_u),
        condition=None if cond is None else jnp.asarray(cond)))
    pipe = port_a14b(trees, in_ch)
    got = pipe.denoise(lat, text_c, text_u, condition=cond)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert pipe.teacache_stats is None and len(pipe.step_seconds) == 4
    # the low tree executed: routing every step to the high tree differs
    hh = port_a14b([trees[0], trees[0]], in_ch)
    out_hh = hh.denoise(lat, text_c, text_u, condition=cond)
    assert (out_hh - got).abs().max() > 0
    swap = port_a14b(trees, in_ch, host_swap=True)
    for _ in range(2):
        out = swap.denoise(lat, text_c, text_u, condition=cond)
        torch.testing.assert_close(out, got, rtol=0, atol=0)
        assert swap.swap_seconds > 0 and swap.load_seconds > 0
        # one tree on the device at a time: the high one is freed
        assert all(p.is_meta for p in swap.high.model.parameters())
        assert not any(p.is_meta for p in swap.low.model.parameters())
    drawn = swap(text_c, text_u, condition=cond, seed=3, num_steps=2)
    assert drawn.shape == (1, 4, *swap.high.grid)


def test_wan22_a14b_sparse_teacache_matches_jax(tmp_path):
    """Sparse layers (warm_last_layers 0 of 2 blocks, warm_layers 1) and
    one TeaCache per tree: each tree's decisions equal JAX's."""
    jmod, trees, _ = wan_trees()
    text_c = arr(11, 1, 6, 32)
    text_u = np.zeros_like(text_c)
    kw = dict(height=192, width=240, frames=5, num_steps=4,
              sa_drop_rate=0.5, p_remain_rates=0.5, mode="sparse",
              scheduler="euler", warm_layers=1, enable_teacache=True,
              teacache_thresh=0.5)
    jpipes = [JWPipe(model=jmod, params=p, interpret=True, **kw)
              for p in trees]
    jpipe = JA14B(high=jpipes[0], low=jpipes[1], boundary_ratio=0.7)
    lat = arr(12, 1, 4, *jpipe.high.grid)
    trace = tmp_path / "trace.json"
    with jtc.trace_to(str(trace)):
        want = np.asarray(jpipe.denoise(*map(jnp.asarray,
                                             (lat, text_c, text_u))))
    jdec = [r["compute"] for r in json.loads(trace.read_text())
            if "call" in r]
    pipe = port_a14b(trees, kw=kw)
    got = pipe.denoise(lat, text_c, text_u).numpy()
    tea = pipe.teacache
    assert tea["high"].decisions + tea["low"].decisions == jdec
    assert pipe.teacache_stats == jpipe.teacache_stats
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [(24, 40), (96, 80)])
def test_load_image_matches_jax(tmp_path, size):
    """The .npy branch (HWC, 0-255) resized down and up, and a .png
    through PIL, against the JAX CLI's loader at 1e-6."""
    from rectified_spaattn_tpu.cli import generate as jgen
    from rectified_spaattn_tpu_torch.cli import generate as tgen
    img = np.random.default_rng(13).uniform(0, 255, (48, 64, 3))
    path = str(tmp_path / "img.npy")
    np.save(path, img.astype(np.float32))
    want = np.asarray(jgen._load_image(path, *size))
    got = tgen._load_image(path, *size).numpy()
    assert got.shape == (1, 3, *size)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    from PIL import Image
    png = str(tmp_path / "img.png")
    Image.fromarray(img.astype(np.uint8)).save(png)
    np.testing.assert_allclose(tgen._load_image(png, *size).numpy(),
                               np.asarray(jgen._load_image(png, *size)),
                               rtol=1e-6, atol=1e-6)


CLI_CASES = {
    "hunyuan-i2v": ([], (1, 16, 2, 8, 8)),
    "hunyuan-i2v-image": (["--image"], (1, 16, 2, 8, 8)),
    "wan22-t2v": ([], (1, 16, 2, 8, 8)),
    "wan22-i2v": ([], (1, 16, 2, 8, 8)),
    "wan22-i2v-image-swap": (["--image", "--host_swap"], (1, 16, 2, 8, 8)),
    "wan22-ti2v-image": (["--image"], (1, 16, 2, 4, 4)),
    "wan21-i2v-image": (["--image"], (1, 16, 2, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_i2v_models_run_on_cpu(case, tmp_path, capsys):
    """Each new model through main() at --scale 0.05 on the CPU, with a
    seeded .npy image where the case names one."""
    from rectified_spaattn_tpu_torch.cli.generate import main
    flags, shape = CLI_CASES[case]
    model = case.split("-image")[0]
    img = str(tmp_path / "x.npy")
    np.save(img, np.random.default_rng(1).uniform(-1, 1, (3, 40, 56)))
    argv = ["--model", model, "--device", "cpu", "--scale", "0.05",
            "--height", "64", "--width", "64",
            "--frame", "8" if model.startswith("hunyuan") else "5",
            "--num_steps", "2", "--enable_teacache",
            "--out_dir", str(tmp_path)]
    for f in flags:
        argv += [f, img] if f == "--image" else [f]
    res = main(argv)
    out = np.load(res["output"])
    assert out.shape == shape and np.isfinite(out).all()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    if model in ("wan22-t2v", "wan22-i2v"):
        assert set(res["teacache"]) == {"high", "low"}


@pytest.mark.parametrize("model", ["hunyuan-i2v", "wan22-ti2v"])
def test_cli_builders_hold_the_first_frame(model, tmp_path):
    """The builders' first frame (the stand-in encoder's latent of
    --image) is held in the output (tests/test_cli.py:179)."""
    from rectified_spaattn_tpu_torch.cli import generate as tgen
    img = str(tmp_path / "x.npy")
    np.save(img, np.random.default_rng(2).uniform(0, 255, (40, 56, 3)))
    args = tgen.parse_args([
        "--model", model, "--device", "cpu", "--scale", "0.05",
        "--height", "64", "--width", "64",
        "--frame", "8" if model == "hunyuan-i2v" else "5",
        "--num_steps", "2", "--image", img])
    args.sa_drop_rate, args.teacache_thresh = tgen.DEFAULTS[model]
    build = tgen.build_hunyuan if model == "hunyuan-i2v" else tgen.build_wan
    pipe, inputs, extra = build(args)
    ff = extra["first_frame"]
    assert ff.shape == (1, 16, 1, *pipe.grid[1:]) and ff.abs().max() > 0
    out = pipe(*inputs, seed=0, **extra)
    torch.testing.assert_close(out[:, :, :1], ff, rtol=0, atol=0)
    assert torch.isfinite(out).all()
    if model == "wan22-ti2v":
        assert pipe.model.cfg.per_token_timesteps
        assert pipe.vae_stride == (4, 32, 32) and pipe.scheduler == "euler"
