"""The port's CogVideoX 1.5 slice against the JAX package on the CPU: the
DDIM scheduler and dynamic CFG, the CogVideoXDiT stages (bridged by
models/convert.py), the T2V / I2V pipelines with TeaCache, the diffusers
converter and config parser, the site at the operating grid, the plan at
head_dim 64, tensor parallelism over two gloo ranks and the CLI.  Same numpy
inputs on both sides; integers, decisions and converted weights bit for
bit; fp32 rtol 2e-4 / atol 2e-5 for the scheduler, 1e-3 / 1e-4 for the DiT
and the one-device pipelines (tests/test_models.py:65), 2e-3 for tp = 2."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import attention as j_attention
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import pretrained as jpre
from rectified_spaattn_tpu.models import weights as jw
from rectified_spaattn_tpu.models.cogvideox import (CogVideoXConfig as JConfig,
                                                    CogVideoXDiT as JDiT)
from rectified_spaattn_tpu.pipelines import CogVideoXPipeline as JPipe
from rectified_spaattn_tpu.pipelines import build_site as j_build_site
from rectified_spaattn_tpu.pipelines import schedulers as jsched
from rectified_spaattn_tpu.pipelines.cogvideox import (
    cog_i2v_condition as j_cog_i2v_condition)
from rectified_spaattn_tpu.sparse import (SparseConfig as JSparse,
                                          build_sparse_plan as j_plan)
from rectified_spaattn_tpu_torch.attention import attention
from rectified_spaattn_tpu_torch.cache import teacache as tc
from rectified_spaattn_tpu_torch.kernels import block_sparse as bs
from rectified_spaattn_tpu_torch.models import (CogVideoXConfig,
                                                CogVideoXDiT,
                                                flax_to_state_dict,
                                                load_flax_params)
from rectified_spaattn_tpu_torch.models import pretrained as pre
from rectified_spaattn_tpu_torch.models import weights as w
from rectified_spaattn_tpu_torch.pipelines import (CogVideoXDDIMScheduler,
                                                   CogVideoXPipeline,
                                                   build_site,
                                                   cog_i2v_condition,
                                                   dynamic_cfg_scale)
from rectified_spaattn_tpu_torch.pipelines import schedulers
from rectified_spaattn_tpu_torch.sparse import SparseConfig, build_sparse_plan

import test_weights as tw

torch.set_num_threads(1)
F32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-3, atol=1e-4)
SITE = dict(rtol=2e-3, atol=2e-3)


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- scheduler

@pytest.mark.parametrize("steps,spacing,shift", [
    (4, "trailing", 1.0), (50, "trailing", 1.0), (7, "leading", 3.0)])
def test_ddim_tables_timesteps_and_step(steps, spacing, shift):
    """The alpha tables (numpy float64 on both sides), the timesteps and
    every step's v-prediction update at fp32 2e-4 / 2e-5."""
    kw = dict(timestep_spacing=spacing, snr_shift_scale=shift)
    ours, theirs = (CogVideoXDDIMScheduler(steps, **kw),
                    jsched.CogVideoXDDIMScheduler(steps, **kw))
    assert ours.alphas_cum.dtype == np.float64
    np.testing.assert_allclose(ours.alphas_cum, theirs.alphas_cum,
                               rtol=1e-12, atol=0)
    assert ours.alphas_cum[-1] == theirs.alphas_cum[-1]
    np.testing.assert_array_equal(ours.timesteps, theirs.timesteps)
    for i in range(steps):
        v, x = arr(2 * i, 1, 4, 2, 4, 4), arr(2 * i + 1, 1, 4, 2, 4, 4)
        got = ours.step(t(v), t(x), i)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs.step(
            jnp.asarray(v), jnp.asarray(x), i)), **F32)
    np.testing.assert_array_equal(
        schedulers._rescale_zero_terminal_snr(ours.alphas_cum[::-1].copy()),
        jsched._rescale_zero_terminal_snr(ours.alphas_cum[::-1].copy()))


def test_dynamic_cfg_scale_keyed_on_raw_timestep():
    for steps in (4, 50):
        for ts in CogVideoXDDIMScheduler(steps).timesteps:
            got = dynamic_cfg_scale(6.0, float(ts), steps)
            want = jsched.dynamic_cfg_scale(6.0, float(ts), steps)
            np.testing.assert_allclose(got, want, **F32)
    # the raw timestep (0..999), not the step index: at t = steps the
    # scale is 1, at t = 999 of 50 steps far from it
    assert dynamic_cfg_scale(6.0, 50.0, 50) == 1.0
    assert dynamic_cfg_scale(6.0, 999.0, 50) != dynamic_cfg_scale(6.0, 0, 50)


# ---------------------------------------------------------------- the DiT

DIT_VARIANTS = {
    "tiny": {},                                       # patch_size_t 1, ofs
    "pt2_ofs": dict(patch_size_t=2),
    "no_ofs": dict(use_ofs_embed=False),
}


def cog_pair(variant="tiny", **extra):
    """The tiny JAX CogVideoXDiT, its params and the port's model holding
    them (load_flax_params)."""
    kw = {**DIT_VARIANTS[variant], **extra}
    jcfg = dataclasses.replace(JConfig.tiny(), **kw)
    jmod = JDiT(jcfg)
    lat = np.zeros((1, jcfg.in_channels, 2 * jcfg.patch_size_t, 8, 8),
                   np.float32)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), lat, np.zeros((1,), np.float32),
        arr(7, 1, 5, jcfg.text_dim)))
    tmod = load_flax_params(CogVideoXDiT(CogVideoXConfig.tiny(**kw)), params)
    return jmod, params, tmod


def vanilla_pair():
    return (lambda q, k, v: j_attention(q, k, v, mode="vanilla"),
            lambda q, k, v: attention(q, k, v, mode="vanilla"))


@pytest.mark.parametrize("variant", list(DIT_VARIANTS))
def test_cogvideox_dit_stages(variant):
    """embed (channel-last patchify, time + ofs embedding, the curve
    permutation of a joint site), run_blocks (shared q/k/v over
    [visual ; text], per-head LayerNorm, RoPE on the visual slice, one
    MLP for both streams) and head (norm_final over concat(ctx, x)) each
    against JAX on the same inputs, and the whole forward."""
    jmod, params, tmod = cog_pair(variant)
    cfg = tmod.cfg
    pt = cfg.patch_size_t
    grid = (2 * pt, 8, 8)
    gt, gh, gw = 2, 4, 4
    lat = arr(9, 1, cfg.in_channels, *grid)
    text = arr(10, 1, 6, cfg.text_dim)
    ts = np.array([700.0], np.float32)
    ofs = np.array([2.0], np.float32)
    _, jl2h, jh2l = j_build_site(gt, gh, gw, sa_drop_rate=0.5, p_remain=0.5,
                                 layout="joint", text_len=128)
    _, l2h, h2l = build_site(gt, gh, gw, sa_drop_rate=0.5, p_remain=0.5,
                             layout="joint", text_len=128, device="cpu")
    np.testing.assert_array_equal(h2l.numpy(), np.asarray(jh2l))
    jf, tf = vanilla_pair()
    jx, jctx, jtemb, (jcos, jsin) = jmod.apply(
        params, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(text), jh2l,
        jnp.asarray(ofs), method=JDiT.embed)
    with torch.no_grad():
        x, ctx, temb, (cos, sin) = tmod.embed(t(lat), t(ts), t(text), h2l,
                                              t(ofs))
    for got, want in ((x, jx), (ctx, jctx), (temb, jtemb), (cos, jcos),
                      (sin, jsin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the blocks and the head on the same (JAX's) inputs
    xs, cs, es = map(np.asarray, (jx, jctx, jtemb))
    rope = (np.asarray(jcos), np.asarray(jsin))
    jxb, jcb = jmod.apply(params, jnp.asarray(xs), jnp.asarray(cs),
                          jnp.asarray(es), tuple(map(jnp.asarray, rope)), jf,
                          method=JDiT.run_blocks)
    with torch.no_grad():
        xb, cb = tmod.run_blocks(t(xs), t(cs), t(es), tuple(map(t, rope)),
                                 tf)
    np.testing.assert_allclose(xb.numpy(), np.asarray(jxb), **TOL)
    np.testing.assert_allclose(cb.numpy(), np.asarray(jcb), **TOL)
    jout = jmod.apply(params, jxb, jcb, jnp.asarray(es), jl2h, *grid,
                      method=JDiT.head)
    with torch.no_grad():
        out = tmod.head(t(np.asarray(jxb)), t(np.asarray(jcb)), t(es), l2h,
                        *grid)
    assert out.shape == (1, cfg.out_channels, *grid)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    want = np.asarray(jmod.apply(
        params, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(text),
        jnp.asarray(ofs), hilbert_to_linear=jh2l, linear_to_hilbert=jl2h))
    with torch.no_grad():
        got = tmod(t(lat), t(ts), t(text), t(ofs), hilbert_to_linear=h2l,
                   linear_to_hilbert=l2h).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_cogvideox_tree():
    """The bridge carries the CogVideoX tree (block_{i}, norm1_lin /
    norm1_ln, norm_q, ff, ofs_in, ...) one to one and strictly."""
    _, params, tmod = cog_pair()
    inner = params["params"]
    sd = flax_to_state_dict(params)
    np.testing.assert_array_equal(sd["blocks.1.to_q.weight"].numpy(),
                                  inner["block_1"]["to_q"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.0.norm_q.weight"].numpy(),
                                  inner["block_0"]["norm_q"]["scale"])
    for key in ("blocks.0.norm1_lin.weight", "blocks.1.norm2_ln.bias",
                "blocks.0.ff.fc2.weight", "ofs_in.weight", "ofs_mlp.fc1.bias",
                "norm_final.weight", "norm_out_lin.bias", "proj_out.weight"):
        assert key in sd, key
    assert sorted(sd) == sorted(tmod.state_dict())
    missing = {k: v for k, v in inner.items() if k != "ofs_in"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(CogVideoXDiT(CogVideoXConfig.tiny()),
                         {"params": missing})


# ---------------------------------------------------------------- pipelines

# TeaCache keyed on temb: the random tiny model's raw signal, scaled by
# 0.1 (the random-weight calibration knob), lands where the cogvideox
# polynomial is positive: calls 2 and 3 skip, 4-7 compute
PIPE_KW = dict(height=128, width=192, frames=25, num_steps=4,
               sa_drop_rate=0.5, p_remain_rates=0.5, teacache_thresh=0.1,
               teacache_signal_scale=0.1, text_len=128)


def decisions(trace_to, run, path):
    with trace_to(str(path)):
        out = run()
    return out, [r["compute"] for r in json.loads(path.read_text())
                 if "call" in r]


@pytest.mark.parametrize("mode", ["vanilla", "sparse"])
@pytest.mark.parametrize("i2v", [False, True])
def test_pipeline_matches_jax(mode, i2v, tmp_path):
    """The tiny T2V and I2V pipelines (4 DDIM steps under dynamic CFG, 8
    calls; 384 visual tokens in 3 blocks + a 128-slot text tail, 5 of
    them valid) in vanilla and sparse modes; JAX runs its Pallas kernels
    in interpret mode.

    TeaCache off: the final latents at 1e-3 / 1e-4.  TeaCache on: the
    same skip decisions (calls 2 and 3 skip), the sparse site on the
    computed calls from call 5 on, the same stats, and the latents within
    the bf16 tolerance 2e-2: a skipped call adds the previous call's
    residual stored in bf16 (the reference's format, on both sides), and
    the few residual elements whose fp32 values straddle a bf16 rounding
    midpoint round one bf16 step apart in the two packages, a difference
    the guidance scale (up to 7) then carries into the latents."""
    extra = dict(in_channels=8, out_channels=4) if i2v else {}
    jmod, params, tmod = cog_pair(**extra)
    g = np.random.default_rng(3)
    grid = (4, 16, 24)
    init = g.normal(size=(1, 4, *grid)).astype(np.float32)
    text_c = np.zeros((1, 128, 32), np.float32)
    text_c[:, :5] = g.normal(size=(1, 5, 32))
    text_u = np.zeros_like(text_c)
    cond = None
    if i2v:
        cond = np.zeros((1, 4, *grid), np.float32)
        cond[:, :, :1] = g.normal(size=(1, 4, 1, *grid[1:]))
    res = {}
    for tea in (False, True):
        kw = dict(PIPE_KW, mode=mode, is_i2v=i2v, enable_teacache=tea)
        jpipe = JPipe(model=jmod, params=params, interpret=True, **kw)
        pipe = CogVideoXPipeline(model=tmod, device="cpu", **kw)
        assert pipe.grid == jpipe.grid == grid
        want, jdec = decisions(jtc.trace_to, lambda: np.asarray(
            jpipe.denoise(jnp.asarray(init), jnp.asarray(text_c),
                          jnp.asarray(text_u),
                          None if cond is None else jnp.asarray(cond))),
            tmp_path / f"j{tea}.json")
        got, dec = decisions(tc.trace_to, lambda: pipe.denoise(
            init, text_c, text_u, cond), tmp_path / f"t{tea}.json")
        assert dec == jdec, (dec, jdec)
        assert pipe.teacache_stats == jpipe.teacache_stats
        computed = [c for c in range(8) if not dec or dec[c]]
        assert pipe.sparse_calls == ([c for c in computed if c >= 5]
                                     if mode == "sparse" else [])
        res[tea] = got.numpy(), want, dec
    got, want, dec = res[False]
    assert dec == []                       # TeaCache off: nothing traced
    np.testing.assert_allclose(got, want, **TOL)
    got, want, dec = res[True]
    assert dec == [True, True, False, False, True, True, True, True], dec
    assert np.abs(got - res[False][0]).max() > 1e-2   # the skips count
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_i2v_condition_and_ofs():
    """cog_i2v_condition holds the encoded first frame and zeros after it,
    as JAX's; I2V sets the ofs input to 2.0 (its embedding changes the
    time embedding), T2V leaves it at 0."""
    grid = (3, 4, 6)

    def enc_np(video):
        return np.tile(video[:, :1, :, :4, :6], (1, 4, 1, 1, 1)) * 0.5

    img = arr(4, 1, 3, 8, 12)
    want = np.asarray(j_cog_i2v_condition(
        jnp.asarray(img), lambda v: jnp.asarray(enc_np(np.asarray(v))),
        grid))
    got = cog_i2v_condition(t(img), lambda v: t(enc_np(v.numpy())), grid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (1, 4, *grid) and got[:, :, 1:].abs().max() == 0
    _, _, tmod = cog_pair()
    lat = arr(5, 1, 4, 2, 8, 8)
    with torch.no_grad():
        e0 = tmod.embed(t(lat), torch.tensor([500.0]),
                        t(arr(6, 1, 5, 32)), None)[2]
        e2 = tmod.embed(t(lat), torch.tensor([500.0]), t(arr(6, 1, 5, 32)),
                        None, torch.tensor([2.0]))[2]
    assert not torch.equal(e0, e2)


def test_pipeline_pads_t5_tokens_and_refuses_scan():
    """A 226-token prompt embedding fills the 256-slot text tail with zeros
    (the valid length 226 masks them); scan_blocks raises."""
    _, _, tmod = cog_pair()
    pipe = CogVideoXPipeline(model=tmod, device="cpu", height=64, width=64,
                             frames=9, num_steps=1, mode="vanilla",
                             text_len=256)
    init = arr(1, 1, 4, *pipe.grid)
    text = arr(2, 1, 226, 32)
    padded = np.concatenate([text, np.zeros((1, 30, 32), np.float32)], 1)
    a = pipe.denoise(init, text, np.zeros_like(text))
    b = pipe.denoise(init, padded, np.zeros_like(padded))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="exceed text_len"):
        pipe.denoise(init, arr(3, 1, 300, 32), arr(3, 1, 300, 32))
    with pytest.raises(NotImplementedError, match="scan_blocks"):
        CogVideoXPipeline(model=tmod, device="cpu", scan_blocks=True)


def test_tensor_parallel_two_gloo_ranks(tmp_path):
    """tp = 2 over two gloo ranks (tests/_torch_dist_workers.py::
    cog_tp_worker: to_q/k/v and ff.fc1 column-, to_out and ff.fc2
    row-parallel, one head a rank) against the JAX single-device
    pipeline at 2e-3, sparse with TeaCache on: both ranks decide as JAX
    does and gate the same calls sparse."""
    from test_torch_parallel import join, spawn
    import _torch_dist_workers as workers
    jmod, params, _ = cog_pair()
    kw = dict(PIPE_KW, mode="sparse", enable_teacache=True, group_rows=2)
    g = np.random.default_rng(5)
    init = g.normal(size=(1, 4, 4, 16, 24)).astype(np.float32)
    text_c = np.zeros((1, 128, 32), np.float32)
    text_c[:, :5] = g.normal(size=(1, 5, 32))
    text_u = np.zeros_like(text_c)
    torch.save(dict(state_dict=flax_to_state_dict(params), kw=kw, init=init,
                    text_c=text_c, text_u=text_u), tmp_path / "cog_tp_in.pt")
    ctx = spawn(workers.cog_tp_worker, 2, tmp_path)
    try:
        jpipe = JPipe(model=jmod, params=params, interpret=True, **kw)
        want, jdec = decisions(jtc.trace_to, lambda: np.asarray(
            jpipe.denoise(*map(jnp.asarray, (init, text_c, text_u)))),
            tmp_path / "j.json")
    finally:
        join(ctx)
    assert False in jdec
    for r in range(2):
        out = torch.load(tmp_path / f"cog_tp_out_{r}.pt", weights_only=False)
        assert out["decisions"] == jdec
        assert out["sparse_calls"] == [c for c in range(5, 8) if jdec[c]]
        assert set(out["heads"]) == {1}
        np.testing.assert_allclose(out["latents"].numpy(), want, **SITE)


# ------------------------------------------------------ checkpoint loading

COG_JSON = dict(num_attention_heads=2, attention_head_dim=32, in_channels=4,
                out_channels=4, num_layers=2, text_embed_dim=32,
                time_embed_dim=32, patch_size=2, patch_size_t=2,
                ofs_embed_dim=32)


def cog10_sd(cfg, rng):
    """synth_cog_sd in the 1.0 layout: a Conv2d patch embed [out, in, p,
    p] and no ofs embedding."""
    sd = tw.synth_cog_sd(cfg, rng)
    d, p = cfg.hidden_dim, cfg.patch_size
    sd["patch_embed.proj.weight"] = rng.standard_normal(
        (d, cfg.in_channels, p, p)).astype(np.float32) * 0.02
    return {k: v for k, v in sd.items() if not k.startswith("ofs_")}


@pytest.mark.parametrize("version", ["1.5", "1.0"])
def test_convert_cogvideox_matches_jax(version):
    """convert_cogvideox (straight to the port's names, in torch) against
    JAX's carried through flax_to_state_dict, bit for bit: 1.5's Linear
    patch embed with the channel-major to channel-last permutation of
    patch_embed's inputs and proj_out's outputs, 1.0's conv patch embed;
    convert_strict reads every key and the port module loads it."""
    if version == "1.5":
        cfg = dataclasses.replace(JConfig.tiny(), patch_size_t=2)
        sd = tw.synth_cog_sd(cfg, np.random.default_rng(3))
    else:
        cfg = dataclasses.replace(JConfig.tiny(), use_ofs_embed=False)
        sd = cog10_sd(cfg, np.random.default_rng(3))
    # distinct proj_out biases, so that the permutation shows
    sd["proj_out.bias"] = np.arange(sd["proj_out.bias"].size,
                                    dtype=np.float32)
    args = (cfg.num_blocks, cfg.use_ofs_embed, cfg.patch_size_t,
            cfg.patch_size)
    got = w.convert_strict("cogvideox", {k: t(v) for k, v in sd.items()},
                           *args)
    want = flax_to_state_dict(jw.convert_cogvideox(sd, *args))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    module = CogVideoXDiT(CogVideoXConfig(**dataclasses.asdict(cfg)))
    module.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="not consumed"):
        w.convert_strict("cogvideox", {**{k: t(v) for k, v in sd.items()},
                                       "stray.weight": torch.zeros(1)},
                         *args)


def test_cogvideox_config_from_json():
    """Field by field against JAX's parser: 1.5 (ofs, patch_size_t 2) and
    1.0 (neither, defaults for the optional keys)."""
    v10 = {k: v for k, v in COG_JSON.items()
           if k not in ("ofs_embed_dim", "text_embed_dim", "time_embed_dim")}
    for c in (COG_JSON, {**v10, "patch_size_t": None}):
        ours = pre.cogvideox_config_from_json(c)
        assert dataclasses.asdict(ours) == dataclasses.asdict(
            jpre.cogvideox_config_from_json(c))
    assert pre.cogvideox_config_from_json(COG_JSON).use_ofs_embed
    assert pre.TEXT_ENCODER_KINDS["cogvideox"] == \
        jpre.TEXT_ENCODER_KINDS["cogvideox"]


def test_load_transformer_cogvideox(tmp_path):
    """A synthetic fp32 snapshot in diffusers' key layout through
    load_transformer equals the converter's output."""
    from safetensors.numpy import save_file
    cfg = pre.cogvideox_config_from_json(COG_JSON)
    sd = tw.synth_cog_sd(JConfig(**dataclasses.asdict(cfg)),
                         np.random.default_rng(8))
    tdir = tmp_path / "transformer"
    os.makedirs(tdir)
    save_file(sd, str(tdir / "diffusion_pytorch_model.safetensors"))
    (tdir / "config.json").write_text(json.dumps(COG_JSON))
    got_cfg, model = pre.load_transformer("cogvideox", str(tmp_path),
                                          dtype="float32", device="cpu",
                                          cache=False)
    assert got_cfg == cfg
    want = w.convert_cogvideox({k: t(v) for k, v in sd.items()},
                               cfg.num_blocks, True, 2, 2)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


# ------------------------------------------------------ the site and plan

def test_build_site_at_the_operating_grid():
    """build_site at CogVideoX1.5's grid (6, 48, 85): 24,480 visual
    tokens (191 blocks + 32 keys), a 256-slot text tail; the curve
    permutations and the neighbour mask equal JAX's bit for bit (no
    attention runs)."""
    kw = dict(sa_drop_rate=0.85, p_remain=0.3, layout="joint", text_len=256)
    jsite, jl2h, jh2l = j_build_site(6, 48, 85, **kw)
    site, l2h, h2l = build_site(6, 48, 85, device="cpu", **kw)
    assert site.visual_len == jsite.visual_len == 24480
    np.testing.assert_array_equal(l2h.numpy(), np.asarray(jl2h))
    np.testing.assert_array_equal(h2l.numpy(), np.asarray(jh2l))
    np.testing.assert_array_equal(site.neighbor_mask.numpy(),
                                  np.asarray(jsite.neighbor_mask))
    assert site.neighbor_mask.shape == (192, 192)
    assert dataclasses.asdict(site.cfg) == dataclasses.asdict(jsite.cfg)


@pytest.mark.parametrize("group_rows", [1, 2])
def test_plan_at_head_dim_64(group_rows):
    """The sparse plan on a small joint grid at head_dim 64 (block 16, a
    partly valid last visual block): mask, indices and counts bit for
    bit, R and comp at fp32 2e-4 / 2e-5."""
    bm, nq, d = 16, 6, 64
    g = np.random.default_rng(21)
    s = nq * bm + bm
    q = g.normal(size=(2, 3, nq * bm, d)).astype(np.float32)
    k, v = (g.normal(size=(2, 3, s, d)).astype(np.float32)
            for _ in range(2))
    nbr = g.uniform(size=(nq, nq)) < 0.3
    tv = np.arange(bm)[None, :] < np.array([[11], [5]])
    kw = dict(top_k_floor=2, p_remain=0.4, layout="joint", text_len=bm,
              block_m=bm, block_n=bm, group_rows=group_rows)
    want = j_plan(*map(jnp.asarray, (q, k, v)), JSparse(**kw),
                  jnp.asarray(nbr), jnp.asarray(tv))
    got = build_sparse_plan(*map(t, (q, k, v)), SparseConfig(**kw), t(nbr),
                            t(tv))
    for name in ("block_mask", "indices", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.r_factor.numpy(),
                               np.asarray(want.r_factor), **F32)
    np.testing.assert_allclose(got.comp.numpy(), np.asarray(want.comp),
                               **F32)


def test_kernel_checks_take_head_dim_64_and_128_only():
    """The CUDA wrappers' checks (run here on CPU tensors: they read only
    shapes and dtypes) accept head_dim 64 and 128 and raise on 96; K1q's
    take 128 only.  No padded launch exists to fall back on."""
    def z(d):
        return torch.zeros((1, 1, 128, d), dtype=torch.bfloat16)
    for d in (64, 128):
        bs._cuda_checks(z(d), z(d), z(d), None, 128, 128)
    with pytest.raises(ValueError, match="head_dim 64 or 128, got 96"):
        bs._cuda_checks(z(96), z(96), z(96), None, 128, 128)
    with pytest.raises(ValueError, match="head_dim 128, got 64"):
        bs._cuda_checks(z(64), None, None, None, 128, 128, head_dims=(128,))
    assert bs._HEAD_DIMS == (64, 128)


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize("model", ["cogvideox-t2v", "cogvideox-i2v"])
def test_cli_runs_on_cpu(model, tmp_path):
    """--model cogvideox-t2v and cogvideox-i2v --image on the CPU (random
    weights at --scale 0.05: 128 wide, 2 heads of 64, 2 blocks); the
    port's levers that its CogVideoX pipeline lacks are refused."""
    from rectified_spaattn_tpu_torch.cli.generate import main
    argv = ["--model", model, "--device", "cpu", "--scale", "0.05",
            "--height", "64", "--width", "96", "--frame", "17",
            "--num_steps", "3", "--enable_teacache", "--group_rows", "2",
            "--out_dir", str(tmp_path)]
    if model.endswith("i2v"):
        img = str(tmp_path / "x.npy")
        np.save(img, np.random.default_rng(0).uniform(0, 255, (48, 40, 3)))
        argv += ["--image", img]
    res = main(argv)
    out = np.load(res["output"])
    assert out.shape == (1, 16, 4, 8, 12) and np.isfinite(out).all()
    assert sum(res["teacache"].values()) == 6
    with pytest.raises(NotImplementedError, match="--density"):
        main(argv + ["--density"])
