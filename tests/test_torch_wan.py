"""The port's Wan2.1 slice against the JAX package on the CPU: the
CrossAttnBlock, the WanDiT (T2V, I2V image cross, per-token timesteps), the
weight bridge on a Wan tree, UniPC, TeaCache's Wan dual-stream decisions,
the tiny sparse WanPipeline and the CLI.  Same numpy inputs, Flax
parameters bridged by models/convert.py; fp32 rtol 1e-3 / atol 1e-4
(tests/test_models.py:65), integers and decisions exact."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import attention as j_attention
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import layers as jl
from rectified_spaattn_tpu.models.wan import (WanConfig as JConfig,
                                              WanDiT as JDiT)
from rectified_spaattn_tpu.pipelines import WanPipeline as JPipe
from rectified_spaattn_tpu.pipelines import schedulers as jsched
from rectified_spaattn_tpu_torch.attention import attention
from rectified_spaattn_tpu_torch.cache import TeaCache
from rectified_spaattn_tpu_torch.models import (WanConfig, WanDiT,
                                                flax_to_state_dict, layers,
                                                load_flax_params)
from rectified_spaattn_tpu_torch.pipelines import WanPipeline

from _jax_forms import JaxUniPC, jax_unipc  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-4)
DIM, HEADS = 64, 2


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def vanilla_pair():
    return (lambda q, k, v: j_attention(q, k, v, mode="vanilla"),
            lambda q, k, v: attention(q, k, v, mode="vanilla"))


@pytest.mark.parametrize("image_cross,per_token", [(False, False),
                                                   (True, False),
                                                   (False, True)])
def test_cross_attn_block(image_cross, per_token):
    """Modulation table + shared temb6 ([B,6,C] or per token [B,S,6,C]),
    full-width q/k RMSNorm, complex RoPE, text cross and (I2V) the image
    cross branch."""
    jf, tf = vanilla_pair()
    sv = 9
    cos, sin = arr(1, sv, DIM // HEADS // 2), arr(2, sv, DIM // HEADS // 2)
    x, ctx = arr(3, 2, sv, DIM), arr(4, 2, 5, DIM)
    temb6 = arr(5, 2, sv, 6, DIM) if per_token else arr(5, 2, 6, DIM)
    ctx_img = arr(6, 2, 4, DIM) if image_cross else None
    jmod = jl.CrossAttnBlock(DIM, HEADS, 4.0, image_cross=image_cross)
    tmod = layers.CrossAttnBlock(DIM, HEADS, 4.0, image_cross=image_cross)
    jr = (jnp.asarray(cos), jnp.asarray(sin))
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), x, ctx, temb6, jr, jf, jf, ctx_img=ctx_img))
    load_flax_params(tmod, params)
    want = np.asarray(jmod.apply(params, x, ctx, temb6, jr, jf, jf,
                                 ctx_img=ctx_img))
    with torch.no_grad():
        got = tmod(t(x), t(ctx), t(temb6), (t(cos), t(sin)), tf, tf,
                   ctx_img=None if ctx_img is None else t(ctx_img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def tiny_pair(image_cross=False, per_token=False, grid=(2, 8, 8)):
    kw = dict(image_cross=image_cross, per_token_timesteps=per_token)
    jcfg = JConfig.tiny(**kw)
    lat = np.zeros((1, jcfg.in_channels, *grid), np.float32)
    n_tok = grid[0] * (grid[1] // 2) * (grid[2] // 2)
    ts = np.zeros((1, n_tok) if per_token else (1,), np.float32)
    text = arr(7, 1, 5, jcfg.text_dim)
    img = arr(8, 1, 4, jcfg.image_dim) if image_cross else None
    jmod = JDiT(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), lat, ts, text, img))
    tmod = load_flax_params(WanDiT(WanConfig.tiny(**kw)), params)
    tmod.text_embedder.act = torch.nn.functional.gelu   # JAX's exact form
    return jmod, params, tmod


@pytest.mark.parametrize("variant", ["t2v", "image_cross", "per_token"])
def test_wan_dit_forward(variant):
    """The whole tiny WanDiT with the curve permutation of a visual site
    (2x8x8 latent grid, 32 tokens)."""
    from rectified_spaattn_tpu.pipelines import build_site as j_build_site
    from rectified_spaattn_tpu_torch.pipelines import build_site
    image_cross, per_token = variant == "image_cross", variant == "per_token"
    jmod, params, tmod = tiny_pair(image_cross, per_token)
    cfg = tmod.cfg
    lat = arr(9, 1, cfg.in_channels, 2, 8, 8)
    text = arr(10, 1, 5, cfg.text_dim)
    img = arr(11, 1, 4, cfg.image_dim) if image_cross else None
    # per-token timesteps in linear token order: frame 0 at t=0
    ts = (np.concatenate([np.zeros((1, 16)), np.full((1, 16), 700.0)], 1)
          .astype(np.float32) if per_token else np.array([500.0], np.float32))
    _, jl2h, jh2l = j_build_site(2, 4, 4, sa_drop_rate=0.5, p_remain=0.5,
                                 layout="visual", first_frame_retention=True)
    _, l2h, h2l = build_site(2, 4, 4, sa_drop_rate=0.5, p_remain=0.5,
                             layout="visual", first_frame_retention=True,
                             device="cpu")
    np.testing.assert_array_equal(h2l.numpy(), np.asarray(jh2l))
    want = np.asarray(jmod.apply(
        params, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(text),
        None if img is None else jnp.asarray(img),
        hilbert_to_linear=jh2l, linear_to_hilbert=jl2h))
    with torch.no_grad():
        got = tmod(t(lat), t(ts), t(text), None if img is None else t(img),
                   hilbert_to_linear=h2l, linear_to_hilbert=l2h).numpy()
    assert got.shape == (1, cfg.out_channels, 2, 8, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_wan_tree_is_strict():
    _, params, _ = tiny_pair(image_cross=True)
    inner = dict(params["params"])
    sd = flax_to_state_dict(params)
    np.testing.assert_array_equal(
        sd["blocks.1.attn1_to_q.weight"].numpy(),
        inner["block_1"]["attn1_to_q"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.0.scale_shift_table"].numpy(),
                                  inner["block_0"]["scale_shift_table"])
    for key in ("scale_shift_table_out", "img_norm1.weight", "img_ff.fc1.bias",
                "text_embedder.fc2.weight", "time_embedder.fc1.weight",
                "blocks.0.attn2_norm_added_k.weight", "blocks.1.norm2.bias"):
        assert key in sd, key
    assert not any(k.startswith("block_") for k in sd)
    cfg = WanConfig.tiny(image_cross=True)
    missing = {k: v for k, v in inner.items() if k != "block_1"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(WanDiT(cfg), {"params": missing})
    extra = {**inner, "block_2": inner["block_1"]}
    with pytest.raises(KeyError, match="unconsumed"):
        load_flax_params(WanDiT(cfg), {"params": extra})
    # a T2V model has no image branch: the I2V tree does not fit it
    with pytest.raises(KeyError, match="unconsumed"):
        load_flax_params(WanDiT(WanConfig.tiny()), params)


def test_unipc_scheduler_ten_steps():
    """UniPC (order 2) over 10 steps: the predictor-corrector chain from
    the same model outputs, the port's built with the JAX package's
    coefficients (its own, the published bh2, are held to the plain
    reference in test_torch_wan_reference.py)."""
    ours, ref = JaxUniPC(10, shift=5.0), jsched.UniPCScheduler(10, shift=5.0)
    np.testing.assert_allclose(ours.timesteps, ref.timesteps)
    x = arr(12, 2, 4, 3, 5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for i in range(10):
        v = arr(100 + i, 2, 4, 3, 5) * 0.5 + 0.1 * x
        xt = ours.step(torch.from_numpy(v), xt, i)
        xj = ref.step(jnp.asarray(v), xj, i)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    assert xt.dtype == torch.float32


@pytest.mark.parametrize("coefficients,ret", [("wan2.1-t2v-14b", 2),
                                              ("wan2.1-t2v-14b-ret", 10),
                                              ("wan2.1-i2v-720p", 2)])
def test_teacache_wan_dual_stream_decisions(coefficients, ret):
    """Wan's even/odd CFG streams: the same signal sequence through both
    controllers, decisions identical call for call."""
    g = np.random.default_rng(13)
    base = g.normal(size=(1, 16)).astype(np.float32)
    sigs = [base * (1 + 0.02 * (i // 2)) + 0.05 * (i % 2)
            + 0.01 * g.normal(size=(1, 16)).astype(np.float32)
            for i in range(20)]
    assert coefficients in jtc.COEFFICIENTS
    for thresh in (0.05, 0.3):
        kw = dict(thresh=thresh, num_steps=20, coefficients=coefficients,
                  ret_steps=ret, cutoff_steps=18, cfg_streams=2)
        ours, ref = TeaCache(**kw), jtc.TeaCache(**kw)
        got = [ours.should_compute(torch.from_numpy(s)) for s in sigs]
        want = [ref.should_compute(jnp.asarray(s)) for s in sigs]
        assert got == want == ours.decisions, kw
        assert ours.stats() == ref.stats()


def pipeline_pair(**kw):
    jmod, params, tmod = tiny_pair()
    jpipe = JPipe(model=jmod, params=params, interpret=True, **kw)
    pipe = WanPipeline(model=tmod, device="cpu", **kw)
    return jpipe, pipe


@pytest.mark.parametrize("warm_calls", [0, 2])
def test_tiny_wan_pipeline_matches_jax(warm_calls, tmp_path, monkeypatch):
    """3 CFG steps of the sparse pipeline: 360 visual tokens (2x12x15
    latent grid) padded once to 384, first-frame retention, warm_layers 1,
    TeaCache on with a skip; decisions identical, latents within 1e-3 /
    1e-4.  warm_calls 0 runs layer 1 sparse from the first call, 2 runs the
    first step dense."""
    kw = dict(height=192, width=240, frames=5, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="sparse", enable_teacache=True,
              teacache_thresh=0.3, warm_layers=1, warm_calls=warm_calls)
    jax_unipc(monkeypatch)
    jpipe, pipe = pipeline_pair(**kw)
    assert pipe.site.visual_len == 360 and pipe.pad == 24
    assert pipe.site.cfg.first_frame_blocks == jpipe.site.cfg.first_frame_blocks == 1
    assert pipe.tea_coefficients() == jpipe.tea_coefficients() == "wan2.1-t2v-14b"
    g = np.random.default_rng(14)
    init = g.normal(size=(1, 4, *pipe.grid)).astype(np.float32)
    text_c = g.normal(size=(1, 6, 32)).astype(np.float32)
    text_u = np.zeros_like(text_c)
    trace = tmp_path / "trace.json"
    with jtc.trace_to(str(trace)):
        want = np.asarray(jpipe.denoise(jnp.asarray(init),
                                        jnp.asarray(text_c),
                                        jnp.asarray(text_u)))
    jdec = [r["compute"] for r in json.loads(trace.read_text())
            if "call" in r]
    got = pipe.denoise(init, text_c, text_u).numpy()
    assert pipe.teacache.decisions == jdec
    assert False in jdec                  # the skip path ran
    assert pipe.teacache_stats == jpipe.teacache_stats
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", ["i2v", "ti2v_first_frame"])
def test_tiny_wan_pipeline_inputs_match_jax(variant):
    """The denoise inputs beyond text: I2V condition channels and a CLIP
    image context (sparse, layers gated only), and TI2V's held first
    latent frame with per-token timesteps (Euler, dense)."""
    g = np.random.default_rng(15)
    if variant == "i2v":
        kw = dict(image_cross=True, in_channels=4 + 4 + 4)
        pkw = dict(mode="sparse", is_i2v=True, warm_layers=1)
    else:
        kw = dict(per_token_timesteps=True)
        pkw = dict(mode="flash", scheduler="euler")
    jcfg = JConfig.tiny(**kw)
    grid = (2, 12, 16)
    n_tok = grid[0] * (grid[1] // 2) * (grid[2] // 2)
    text_c = g.normal(size=(1, 6, jcfg.text_dim)).astype(np.float32)
    text_u = np.zeros_like(text_c)
    extra = {}
    if variant == "i2v":
        extra["image_emb"] = g.normal(size=(1, 4, 16)).astype(np.float32)
        extra["condition"] = g.normal(size=(1, 8, *grid)).astype(np.float32)
        ts0 = np.zeros((1,), np.float32)
    else:
        extra["first_frame"] = g.normal(size=(1, 4, 1, *grid[1:])).astype(
            np.float32)
        ts0 = np.zeros((1, n_tok), np.float32)
    jmod = JDiT(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), np.zeros((1, jcfg.in_channels, *grid),
                                        np.float32),
        ts0, text_c, extra.get("image_emb")))
    tmod = load_flax_params(WanDiT(WanConfig.tiny(**kw)), params)
    tmod.text_embedder.act = torch.nn.functional.gelu   # JAX's exact form
    common = dict(height=96, width=128, frames=5, num_steps=2,
                  sa_drop_rate=0.5, p_remain_rates=0.5, **pkw)
    jpipe = JPipe(model=jmod, params=params, interpret=True, **common)
    pipe = WanPipeline(model=tmod, device="cpu", **common)
    assert pipe.grid == jpipe.grid == grid
    init = g.normal(size=(1, 4, *grid)).astype(np.float32)
    want = np.asarray(jpipe.denoise(
        jnp.asarray(init), jnp.asarray(text_c), jnp.asarray(text_u),
        **{k: jnp.asarray(v) for k, v in extra.items()}))
    got = pipe.denoise(init, text_c, text_u, **extra).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if variant == "ti2v_first_frame":
        np.testing.assert_array_equal(got[:, :, :1], extra["first_frame"])


def test_wan_pipeline_unported_options_raise():
    _, _, tmod = tiny_pair()
    # the int8 / offloaded TeaCache residual is ported (test_torch_quant.py),
    # and scan_blocks with its windows (test_torch_scan.py); windows alone
    # raise, as the JAX pipeline does
    pipe = WanPipeline(model=tiny_pair()[2], height=64, width=64, frames=5,
                       device="cpu", scan_blocks=True, dispatch_segments=2)
    assert len(pipe.stack) == pipe.model.cfg.num_blocks
    with pytest.raises(ValueError, match="requires scan_blocks"):
        WanPipeline(model=tmod, height=64, width=64, frames=5, device="cpu",
                    dispatch_segments=2)
    # defer_device is ported (Wan22A14BPipeline host_swap,
    # tests/test_torch_i2v.py): it leaves the weights where they are, and
    # refuses a mesh as the JAX pipeline asserts
    from rectified_spaattn_tpu_torch.parallel import in_process_mesh
    pipe = WanPipeline(model=tmod, height=64, width=64, frames=5,
                       device="cpu", defer_device=True)
    assert pipe.model is tmod
    with pytest.raises(ValueError, match="defer_device"):
        WanPipeline(model=tmod, height=64, width=64, frames=5, device="cpu",
                    defer_device=True, mesh=in_process_mesh(sp=1))
    # ``mesh`` is ported (tests/test_torch_parallel.py); the pipelines shard
    # over a torch.distributed tp group only
    for mesh, msg in ((in_process_mesh(sp=2), "tp only"),
                      (in_process_mesh(sp=1), "torch.distributed")):
        with pytest.raises(ValueError, match=msg):
            WanPipeline(model=tmod, height=64, width=64, frames=5,
                        device="cpu", mesh=mesh)


def test_cli_wan21_t2v_runs_on_cpu(tmp_path, capsys):
    from rectified_spaattn_tpu_torch.cli.generate import main
    res = main(["--model", "wan21-t2v", "--device", "cpu", "--scale", "0.05",
                "--height", "64", "--width", "64", "--frame", "5",
                "--num_steps", "2", "--enable_teacache",
                "--out_dir", str(tmp_path)])
    out = np.load(res["output"])
    assert out.shape == (1, 16, 2, 8, 8) and np.isfinite(out).all()
    assert res["teacache"] == {"skipped": 0, "computed": 4}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    # --image conditions wan21-i2v (tests/test_torch_i2v.py)
    img = str(tmp_path / "x.npy")
    np.save(img, np.random.default_rng(0).uniform(-1, 1, (3, 40, 48)))
    res = main(["--model", "wan21-i2v", "--device", "cpu", "--scale", "0.05",
                "--height", "64", "--width", "64", "--frame", "5",
                "--num_steps", "2", "--image", img,
                "--out_dir", str(tmp_path)])
    out = np.load(res["output"])
    assert out.shape == (1, 16, 2, 8, 8) and np.isfinite(out).all()
