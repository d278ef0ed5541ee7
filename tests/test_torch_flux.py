"""The port's Flux.1-dev upscale slice against the JAX package on the CPU:
the mu-shifted Euler, the 2x2 token packing, the ControlNet sample
distribution, the bicubic resize, FluxDiT and FluxControlNet (bridged by
models/convert.py), FluxPipeline and FluxUpscalePipeline, the diffusers
converters, config parsers and loaders, tensor parallelism over two gloo
ranks and the CLI.  Same numpy inputs on both sides; schedules, integers,
decisions, packing and converted weights bit for bit; the resize at fp32
rtol 2e-4 / atol 2e-5; the DiT, the ControlNet and the pipelines at
1e-3 / 1e-4 (tests/test_models.py:65); tp = 2 at 2e-3."""

import dataclasses
import functools
import json
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from rectified_spaattn_tpu.attention import attention as j_attention
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import pretrained as jpre
from rectified_spaattn_tpu.models import weights as jw
from rectified_spaattn_tpu.models.flux import (
    FluxConfig as JConfig, FluxControlNet as JCN,
    FluxControlNetConfig as JCNConfig, FluxDiT as JDiT,
    distribute_controlnet_samples as j_distribute)
from rectified_spaattn_tpu.pipelines import build_site as j_build_site
from rectified_spaattn_tpu.pipelines import schedulers as jsched
from rectified_spaattn_tpu.pipelines.flux import (
    FluxPipeline as JPipe, FluxUpscalePipeline as JUpscale,
    flux_pack_latents as j_pack, flux_unpack_latents as j_unpack)
from rectified_spaattn_tpu_torch.attention import attention
from rectified_spaattn_tpu_torch.cache import teacache as tc
from rectified_spaattn_tpu_torch.models import (
    FluxConfig, FluxControlNet, FluxControlNetConfig, FluxDiT,
    distribute_controlnet_samples, flax_to_state_dict, init_controlnet_weights,
    load_flax_params)
from rectified_spaattn_tpu_torch.models import pretrained as pre
from rectified_spaattn_tpu_torch.models import weights as w
from rectified_spaattn_tpu_torch.pipelines import (
    FlowMatchEulerScheduler, FluxPipeline, FluxUpscalePipeline, build_site,
    flux_mu_shift, flux_pack_latents, flux_unpack_latents, resize_bicubic)

import test_weight_manifests as manifests
import test_weights as tw

torch.set_num_threads(1)
F32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-3, atol=1e-4)
TP = dict(rtol=2e-3, atol=2e-3)


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- scheduler

@pytest.mark.parametrize("seq_len,steps", [(256, 4), (4096, 28),
                                           (65536, 2), (65536, 28)])
def test_mu_shift_and_sigmas(seq_len, steps):
    """flux_mu_shift and the mu-Euler sigmas equal JAX's in float64 (65,536
    tokens extrapolate to mu = 11.55: every sigma but the last near 1);
    each step's update at fp32 2e-4 / 2e-5, kept fp32 for a bf16 model
    output."""
    mu = flux_mu_shift(seq_len)
    assert mu == jsched.flux_mu_shift(seq_len)
    ours = FlowMatchEulerScheduler(steps, use_mu=True, mu=mu)
    theirs = jsched.FlowMatchEulerScheduler(steps, use_mu=True, mu=mu)
    assert ours.sigmas.dtype == np.float64
    np.testing.assert_array_equal(ours.sigmas, theirs.sigmas)
    np.testing.assert_array_equal(ours.timesteps, theirs.timesteps)
    if seq_len == 65536:
        assert abs(mu - 11.55) < 1e-9 and ours.sigmas[-2] > 0.999
    v, x = arr(1, 1, 6, 8), arr(2, 1, 6, 8)
    for i in range(steps):
        got = ours.step(t(v).to(torch.bfloat16), t(x), i)
        assert got.dtype == torch.float32
        want = x + np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32) * (
            theirs.sigmas[i + 1] - theirs.sigmas[i])
        np.testing.assert_allclose(got.numpy(), want, **F32)
    # without use_mu the HunyuanVideo shift stands
    np.testing.assert_array_equal(
        FlowMatchEulerScheduler(steps).sigmas,
        jsched.FlowMatchEulerScheduler(steps).sigmas)


# ---------------------------------------------------- packing, samples, resize

def test_pack_unpack_bit_for_bit():
    lat = arr(3, 2, 5, 6, 8)
    want = np.asarray(j_pack(jnp.asarray(lat)))
    got = flux_pack_latents(t(lat))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (2, 12, 20)
    # feature index c*4 + dy*2 + dx
    assert got[0, 0, 1 * 4 + 1 * 2 + 0] == t(lat)[0, 1, 1, 0]
    back = flux_unpack_latents(got, 3, 4)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_unpack(jnp.asarray(want), 3, 4)))
    np.testing.assert_array_equal(back.numpy(), lat)


@pytest.mark.parametrize("n_blocks,n_samples", [(19, 5), (38, 5), (19, 19),
                                                (3, 5), (7, 1), (4, 0)])
def test_distribute_controlnet_samples(n_blocks, n_samples):
    samples = list(range(n_samples))
    got = distribute_controlnet_samples(samples, n_blocks)
    assert got == j_distribute(samples, n_blocks)
    if n_samples:
        assert len(got) == n_blocks


@pytest.mark.parametrize("shape,ratio", [((1, 3, 16, 16), 4),
                                         ((2, 3, 5, 7), 2),
                                         ((1, 2, 9, 5), 4),
                                         ((1, 1, 1, 3), 2)])
def test_resize_bicubic_matches_jax(shape, ratio):
    """jax.image.resize(method="bicubic") on odd sizes too, at fp32 2e-4 /
    2e-5; F.interpolate's bicubic (a = -0.75, clamped border) is a
    different function on the same input."""
    x = arr(4, *shape)
    size = (shape[2] * ratio, shape[3] * ratio)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (*shape[:2], *size),
                                       method="bicubic"))
    got = resize_bicubic(t(x), *size)
    assert got.dtype == torch.float32 and got.shape == (*shape[:2], *size)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    if shape == (1, 3, 16, 16):
        other = F.interpolate(t(x), size=size, mode="bicubic",
                              align_corners=False)
        assert float((other - got).abs().max()) > 0.05


def test_resize_bicubic_shrinks_as_jax():
    """A shrink (the kernel widened by the ratio) agrees too."""
    x = arr(5, 1, 2, 12, 9)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, 5, 4),
                                       method="bicubic"))
    np.testing.assert_allclose(resize_bicubic(t(x), 5, 4).numpy(), want,
                               **F32)


# ---------------------------------------------------------- DiT, ControlNet

TEXT_LEN = 128
GRID = (16, 16)               # 256 visual tokens: 2 blocks of 128


@functools.lru_cache(maxsize=None)
def flux_pair():
    """The tiny JAX FluxDiT, its params and the port's model holding them
    (made once: the pipelines read the model and never change it)."""
    jcfg = JConfig.tiny()
    jmod = JDiT(jcfg)
    tokens = np.zeros((1, 64, jcfg.in_channels), np.float32)
    params = np_tree(jax.jit(jmod.init, static_argnums=(6, 7))(
        jax.random.PRNGKey(0), tokens, jnp.array([0.5]),
        arr(7, 1, TEXT_LEN, jcfg.text_dim), arr(8, 1, jcfg.pooled_dim),
        jnp.array([3.5]), 8, 8))
    return jmod, params, load_flax_params(FluxDiT(FluxConfig.tiny()), params)


@functools.lru_cache(maxsize=None)
def cn_pair(nudge: float):
    """The tiny JAX FluxControlNet (zero-initialised conditioning embedder
    and projections), every leaf moved by nudge * N(0, 1), and the port's
    model holding the same weights."""
    jcfg = JCNConfig.tiny()
    jmod = JCN(jcfg)
    tokens = np.zeros((1, 64, jcfg.in_channels), np.float32)
    params = np_tree(jax.jit(jmod.init, static_argnums=(7, 8))(
        jax.random.PRNGKey(1), tokens, tokens, jnp.array([0.5]),
        arr(7, 1, TEXT_LEN, jcfg.text_dim), arr(8, 1, jcfg.pooled_dim),
        jnp.array([3.5]), 8, 8))
    g = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda x: (x + nudge * g.normal(size=x.shape)).astype(x.dtype),
        params)
    return jmod, params, load_flax_params(
        FluxControlNet(FluxControlNetConfig.tiny()), params)


def sites():
    kw = dict(sa_drop_rate=0.5, p_remain=0.5, layout="joint",
              text_len=TEXT_LEN)
    jsite, jl2h, jh2l = j_build_site(1, *GRID, **kw)
    site, l2h, h2l = build_site(1, *GRID, device="cpu", **kw)
    np.testing.assert_array_equal(h2l.numpy(), np.asarray(jh2l))
    return (jsite, jl2h, jh2l), (site, l2h, h2l)


def dit_inputs():
    c = JConfig.tiny()
    tlen = np.array([23], np.int32)
    text = arr(10, 1, TEXT_LEN, c.text_dim)
    text[:, tlen[0]:] = 0
    return dict(tokens=arr(9, 1, GRID[0] * GRID[1], c.in_channels),
                ts=np.array([0.7], np.float32), text=text,
                pooled=arr(11, 1, c.pooled_dim),
                guidance=np.array([3.5], np.float32), tlen=tlen)


@pytest.mark.parametrize("mode", ["vanilla", "sparse"])
def test_flux_dit_stages(mode):
    """embed (the 2-D RoPE over (0, y, x) permuted by h2l, the time +
    pooled + guidance embedding), the TeaCache signal, run_blocks with one
    attention function per block (the site's sparse function on the dual
    block and the windowed dense on the single one under "sparse") and
    head, each against JAX on the same inputs; the forward is the three
    stages."""
    jmod, params, tmod = flux_pair()
    (jsite, jl2h, jh2l), (site, l2h, h2l) = sites()
    d = dit_inputs()
    names = ("tokens", "ts", "text", "pooled", "guidance")

    @jax.jit
    def j_embed(*a):
        x, ctx, temb, rope = jmod.apply(params, *a, *GRID, jh2l,
                                        method=JDiT.embed)
        sig = jmod.apply(params, x, temb, method=JDiT.teacache_signal)
        return x, ctx, temb, rope, sig

    jx, jctx, jtemb, (jcos, jsin), jsig = j_embed(
        *(jnp.asarray(d[n]) for n in names))
    with torch.no_grad():
        x, ctx, temb, (cos, sin) = tmod.embed(*(t(d[n]) for n in names),
                                              *GRID, h2l)
        sig = tmod.teacache_signal(x, temb)
    for got, want in ((x, jx), (ctx, jctx), (temb, jtemb), (cos, jcos),
                      (sin, jsin), (sig, jsig)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tlen = d["tlen"]
    if mode == "vanilla":
        jfns = [lambda q, k, v: j_attention(q, k, v, mode="vanilla")] * 2
        tfns = [lambda q, k, v: attention(q, k, v, mode="vanilla")] * 2
    else:
        jfns = [jsite.attn_fn("sparse", text_len_rt=jnp.asarray(tlen),
                              interpret=True),
                jsite.attn_fn("vanilla", text_len_rt=jnp.asarray(tlen),
                              interpret=True)]
        tfns = [site.attn_fn("sparse", text_len_rt=t(tlen)),
                site.attn_fn("flash", text_len_rt=t(tlen))]
    xs, cs, es = map(np.asarray, (jx, jctx, jtemb))
    rope = (np.asarray(jcos), np.asarray(jsin))

    @jax.jit
    def j_blocks_head(*a):
        xb, cb = jmod.apply(params, *a, jfns[0], jfns[:1], jfns[1:],
                            method=JDiT.run_blocks)
        return xb, cb, jmod.apply(params, xb, a[2], jl2h, method=JDiT.head)

    jxb, jcb, jout = j_blocks_head(*map(jnp.asarray, (xs, cs, es)),
                                   tuple(map(jnp.asarray, rope)))
    with torch.no_grad():
        xb, cb = tmod.run_blocks(t(xs), t(cs), t(es), tuple(map(t, rope)),
                                 None, tfns[:1], tfns[1:])
        out = tmod.head(t(np.asarray(jxb)), t(es), l2h)
    np.testing.assert_allclose(xb.numpy(), np.asarray(jxb), **TOL)
    np.testing.assert_allclose(cb.numpy(), np.asarray(jcb), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    if mode == "vanilla":
        with torch.no_grad():
            whole = tmod(*(t(d[n]) for n in names), *GRID, h2l, l2h)
            staged = tmod.head(*tmod.run_blocks(
                x, ctx, temb, (cos, sin), tfns[0])[:1], temb, l2h)
        torch.testing.assert_close(whole, staged, rtol=0, atol=0)


def test_controlnet_matches_jax():
    """FluxControlNet (nudged) against JAX's module with the same
    hilbert_to_linear: the port's default attention (dense flash, K3's
    plain version on the CPU) against JAX's unmasked vanilla over every
    token, padded text slots included.  Its curve-order samples are also
    the reference's composition: the ControlNet in linear order with its
    samples permuted afterwards (main_upflux.py:114-116).  The JAX
    pipeline's own controlnet_fn permutes only the control tokens (the
    latent tokens and RoPE stay linear), so it computes another function
    (ROADMAP Queue 3)."""
    jcn, cparams, tcn = cn_pair(0.05)
    (_, _, jh2l), (_, _, h2l) = sites()
    d = dit_inputs()
    control = arr(12, *d["tokens"].shape)
    jin = (jnp.asarray(d["tokens"]), jnp.asarray(control),
           jnp.asarray(d["ts"]), jnp.asarray(d["text"]),
           jnp.asarray(d["pooled"]), jnp.asarray(d["guidance"]))
    # (tokens, control, ts, text, pooled, guidance, h2l, scale)
    apply = jax.jit(lambda *a: jcn.apply(cparams, *a[:6], *GRID, *a[6:]))
    jd, js = apply(*jin, jh2l, 0.8)
    with torch.no_grad():
        td, ts_ = tcn(*map(t, (d["tokens"], control, d["ts"], d["text"],
                               d["pooled"], d["guidance"])), *GRID, h2l, 0.8)
    assert len(td) == 2 and ts_ == [] and js == []
    for got, want in zip(td, jd):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lin, _ = apply(*jin, None, 0.8)
    for got, want in zip(td, lin):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want)[:, np.asarray(jh2l)],
                                   **TOL)
    mixed, _ = apply(jin[0], jnp.take(jin[1], jh2l, axis=1), *jin[2:],
                     None, 0.8)
    assert float(np.abs(np.asarray(mixed[0]) - td[0].numpy()).max()) > 1e-2
    # zero-initialised: every sample is exactly zero
    zero = FluxControlNet(FluxControlNetConfig.tiny())
    with torch.no_grad():
        zd, _ = zero(*map(t, (d["tokens"], control, d["ts"], d["text"],
                              d["pooled"], d["guidance"])), *GRID, h2l)
    assert all(float(s.abs().max()) == 0.0 for s in zd)


def test_init_controlnet_weights():
    """Seeded and zero at the outputs without a nudge; a nudge moves every
    parameter."""
    gen = torch.Generator().manual_seed(3)
    a = init_controlnet_weights(FluxControlNet(FluxControlNetConfig.tiny()),
                                gen)
    assert all(float(m.weight.abs().max()) == 0 for m in a.output_layers())
    b = init_controlnet_weights(FluxControlNet(FluxControlNetConfig.tiny()),
                                torch.Generator().manual_seed(3), nudge=0.02)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert not torch.equal(pa, pb), n


# ---------------------------------------------------------------- pipelines

PIPE_KW = dict(sa_drop_rate=0.5, p_remain_rates=0.5, mode="sparse",
               text_len=TEXT_LEN, rel_l1_thresh=0.8)


@functools.lru_cache(maxsize=None)
def jax_pipe(hw: int, gate: tuple, mode: str = "sparse"):
    """The JAX FluxPipeline of the tiny model at hw x hw under ``gate``,
    made once so its jitted stages compile once; the tests set
    num_steps and enable_teacache, which its denoise reads per call."""
    jmod, params, _ = flux_pair()
    return JPipe(model=jmod, params=params, height=hw, width=hw,
                 sparse_layer_gate=gate, interpret=True,
                 **dict(PIPE_KW, mode=mode))


def pipe_inputs():
    c = JConfig.tiny()
    g = np.random.default_rng(13)
    text = np.zeros((1, TEXT_LEN, c.text_dim), np.float32)
    text[:, :7] = g.normal(size=(1, 7, c.text_dim))
    mask = np.zeros((1, TEXT_LEN), bool)
    mask[:, :7] = True
    return text, mask, g.normal(size=(1, c.pooled_dim)).astype(np.float32)


def decisions(trace_to, run, path):
    with trace_to(str(path)):
        out = run()
    return out, [r["compute"] for r in json.loads(path.read_text())
                 if "call" in r]


@pytest.mark.parametrize("gate,tea", [((99, 99), False), ((1, 2), False),
                                      ((1, 2), True)])
def test_flux_pipeline_matches_jax(gate, tea, tmp_path):
    """FluxPipeline at 256x256 (256 visual tokens in 2 blocks + a 128-slot
    text tail, 7 valid), 2 mu-Euler steps (4 with TeaCache), sparse mode
    under the gate (99, 99) (both blocks sparse) and (1, 2) (the single block, fused id
    1, in the dense band: the windowed dense); JAX runs its Pallas kernels
    in interpret mode.  TeaCache off: the tokens at 1e-3 / 1e-4.
    TeaCache on (4 steps, thresh 0.8 on the flux-dev polynomial): the
    same decisions (with a skip) and stats, and the tokens within the bf16
    tolerance 2e-2: a skipped step adds the previous step's residual
    stored in bf16 (the reference's format, on both sides), and residual
    elements whose fp32 values straddle a bf16 rounding midpoint round one
    bf16 step apart in the two packages."""
    _, _, tmod = flux_pair()
    text, mask, pooled = pipe_inputs()
    init = arr(14, 1, GRID[0] * GRID[1], 8)
    steps = 4 if tea else 2
    jpipe = jax_pipe(256, gate)
    jpipe.enable_teacache = tea
    pipe = FluxPipeline(model=tmod, device="cpu", height=256, width=256,
                        sparse_layer_gate=gate, enable_teacache=tea,
                        **PIPE_KW)
    assert (pipe.gh, pipe.gw) == (jpipe.gh, jpipe.gw) == GRID
    want, jdec = decisions(jtc.trace_to, lambda: np.asarray(jpipe.denoise(
        *map(jnp.asarray, (init, text, mask, pooled)), num_steps=steps)),
        tmp_path / "j.json")
    got, dec = decisions(tc.trace_to, lambda: pipe.denoise(
        init, text, mask, pooled, num_steps=steps), tmp_path / "t.json")
    assert dec == jdec
    assert pipe.teacache_stats == jpipe.teacache_stats
    if tea:
        assert False in dec and dec[0] and dec[-1], dec
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    duals, singles = pipe.attn_fns(torch.tensor([7], dtype=torch.int32))
    # (99, 99): one sparse function for both blocks; (1, 2): the single
    # block (fused id 1) runs the windowed dense
    assert (duals[0] is singles[0]) == (gate == (99, 99))


def test_pipeline_gate_and_modes():
    """Under "sparse" the gate picks the site's sparse function outside
    the dense band and the windowed dense inside it (Flux's (37, 57) over
    19 + 38 blocks: 37 sparse, 20 dense); "flash" and "vanilla" run every
    block dense; scan_blocks, once refused, stacks the trunk's two lists
    (tests/test_torch_scan.py runs it)."""
    cfg = FluxConfig(hidden_dim=64, heads=2, head_dim=32, text_dim=32,
                     pooled_dim=16, in_channels=8, out_channels=8,
                     rope_axes_dim=(8, 12, 12))
    with torch.device("meta"):
        model = FluxDiT(cfg)
    # the gate alone, on a stand-in site that names the mode it is asked
    # for (the 57-block model is built on the meta device)
    pipe = FluxPipeline.__new__(FluxPipeline)
    pipe.model, pipe.mode, pipe.sparse_layer_gate = model, "sparse", (37, 57)
    pipe.site = type("S", (), {"attn_fn": lambda self, mode, **kw: mode})()
    duals, singles = pipe.attn_fns(None)
    modes = duals + singles
    assert len(modes) == 57
    assert modes.count("sparse") == 37 and modes.count("flash") == 20
    # fused ids 0-36 sparse (the 19 dual and single 0-17), single 18-37
    # (ids 37-56) dense
    assert modes[:37] == ["sparse"] * 37 and modes[37:] == ["flash"] * 20
    for mode, dense in (("flash", "flash"), ("vanilla", "vanilla")):
        pipe.mode = mode
        assert set(sum(pipe.attn_fns(None), [])) == {dense}
    _, params, _ = flux_pair()
    tmod = load_flax_params(FluxDiT(FluxConfig.tiny()), params)
    stacks = FluxPipeline(model=tmod, device="cpu", scan_blocks=True).stacks
    assert [len(s) for s in stacks] == [1, 1]
    assert all(s.blocks is b for s, b in zip(stacks, (tmod.dual_blocks,
                                                      tmod.single_blocks)))


UP_KW = dict(PIPE_KW, num_steps=2, mode="vanilla")


def upscale_pair(tcn=None, jcn=None, cparams=None, jvae=None, tvae=None):
    """The JAX and port upscale pipelines of the tiny model: base 64x64
    (16 tokens), up 256x256 (256 tokens), 2 steps each, TeaCache off, in
    vanilla mode (test_flux_pipeline_matches_jax holds the sparse stages;
    these hold the composition of the two)."""
    _, _, tmod = flux_pair()
    jbase, jup = (jax_pipe(hw, (37, 57), "vanilla") for hw in (64, 256))
    for p in (jbase, jup):
        p.num_steps, p.enable_teacache = 2, False
    mk_t = lambda hw: FluxPipeline(model=tmod, height=hw, width=hw,
                                   device="cpu", **UP_KW)
    jv, tv = jvae or (None, None), tvae or (None, None)
    return (JUpscale(base=jbase, up=jup, controlnet=jcn,
                     controlnet_params=cparams, vae_encode=jv[0],
                     vae_decode=jv[1]),
            FluxUpscalePipeline(base=mk_t(64), up=mk_t(256), controlnet=tcn,
                                vae_encode=tv[0], vae_decode=tv[1]))


def jax_noise(seed, c_in=8):
    """The JAX pipelines' own noise: PRNGKey(seed) for the base stage,
    PRNGKey(seed + 1) for the up stage."""
    base = jax.random.normal(jax.random.PRNGKey(seed), (1, 16, c_in),
                             jnp.float32)
    up = jax.random.normal(jax.random.PRNGKey(seed + 1), (1, 256, c_in),
                           jnp.float32)
    return np.asarray(base), np.asarray(up)


def nearest_control(base_tokens):
    g = np.asarray(base_tokens).reshape(1, 4, 4, -1)
    g = np.repeat(np.repeat(g, 4, axis=1), 4, axis=2)
    return g.reshape(1, 256, -1)


def test_upscale_without_and_with_zero_controlnet():
    """No ControlNet: the img2img fallback at strength 0.7 from the
    nearest latent upsample, against JAX's FluxUpscalePipeline given its
    own noise.  A zero-initialised ControlNet is an exact no-op: equal to
    the fallback at strength 1 (pure noise) bit for bit."""
    text, mask, pooled = pipe_inputs()
    jp, tp = upscale_pair()
    bn, un = jax_noise(5)
    want = np.asarray(jp(*map(jnp.asarray, (text, mask, pooled)), seed=5))
    got = tp(text, mask, pooled, base_init=bn, up_noise=un)
    assert got.shape == (1, 256, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tp.control_tokens(tp.base(text, mask, pooled,
                                  init_tokens=bn)).numpy(),
        nearest_control(jp.base(*map(jnp.asarray, (text, mask, pooled)),
                                init_tokens=jnp.asarray(bn))), **TOL)
    zero = FluxControlNet(FluxControlNetConfig.tiny())
    _, tz = upscale_pair(tcn=zero)
    tp.strength = 1.0
    torch.testing.assert_close(
        tz(text, mask, pooled, base_init=bn, up_noise=un),
        tp(text, mask, pooled, base_init=bn, up_noise=un), rtol=0, atol=0)


def test_upscale_with_nudged_controlnet_matches_jax():
    """A nudged ControlNet conditions the up stage from pure noise: the
    port's pipeline against JAX's FluxUpscalePipeline driven with the
    reference's ControlNet function (JAX's FluxControlNet over the
    linear-order tokens and control, permuted by h2l inside), the same
    noise on both sides; the base image shapes the output."""
    jcn, cparams, tcn = cn_pair(0.05)
    text, mask, pooled = pipe_inputs()
    jp, tp = upscale_pair(tcn, jcn, cparams)
    bn, un = jax_noise(6)
    jt, jm_, jpo = map(jnp.asarray, (text, mask, pooled))
    control = jnp.asarray(nearest_control(jp.base(jt, jm_, jpo,
                                                  init_tokens=bn)))
    g = jnp.full((1,), jp.up.guidance_scale)
    run = jax.jit(lambda tokens, ts: jcn.apply(
        cparams, tokens, control, ts, jt, jpo, g, 16, 16, jp.up.h2l, 1.0))

    def fn(tokens, tt):
        return run(tokens, jnp.full((1,), float(tt) / 1000.0))

    want = np.asarray(jp.up(jt, jm_, jpo, controlnet_fn=fn,
                            init_tokens=jnp.asarray(un)))
    got = tp(text, mask, pooled, base_init=bn, up_noise=un)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    other = tp(text, mask, pooled, base_init=arr(15, 1, 16, 8), up_noise=un)
    assert float((other - got).abs().max()) > 1e-3


def tiny_image_vae():
    """A 2-D AutoencoderKL of stride 4 (4 latent channels: the tiny
    model's 16 packed features) with shift_factor, on both sides."""
    from rectified_spaattn_tpu.models import vae as jvae
    from rectified_spaattn_tpu_torch.models import vae as tvae
    kw = dict(latent_channels=2, block_out_channels=(8, 16, 16),
              layers_per_block=1, temporal_upsample=(False,) * 3,
              spatial_upsample=(True, True, False), video=False,
              mid_attention=True, scaling_factor=0.5, shift_factor=0.1)
    jcfg = jvae.VAEConfig(**kw)
    sd = tw.synth_vae_sd(jcfg, np.random.default_rng(16))
    jdec = jvae.VAEDecoder(jcfg)
    jenc = jvae.VAEEncoder(jcfg)
    dp = jw.convert_vae_decoder(sd, 3, 1, False)
    ep = jw.convert_vae_encoder(sd, 3, 1, False)
    tcfg = tvae.VAEConfig(**kw)
    dec = load_flax_params(tvae.VAEDecoder(tcfg), dp).eval()
    enc = load_flax_params(tvae.VAEEncoder(tcfg), ep).eval()
    return ((jax.jit(lambda px: jenc.apply(ep, px)),
             jax.jit(lambda z: jdec.apply(dp, z))),
            (torch.no_grad()(enc), torch.no_grad()(dec)))


def test_upscale_pixel_control_path_matches_jax():
    """The reference's control prep with a VAE: decode the base image,
    resize (bicubic) 4x, encode, pack; the img2img fallback from it,
    against JAX's pipeline with the same VAE weights and noise."""
    jv, tv = tiny_image_vae()
    text, mask, pooled = pipe_inputs()
    jp, tp = upscale_pair(jvae=jv, tvae=tv)
    bn, un = jax_noise(7)
    seen = []
    enc = tp.vae_encode
    tp.vae_encode = lambda px: seen.append(tuple(px.shape)) or enc(px)
    want = np.asarray(jp(*map(jnp.asarray, (text, mask, pooled)), seed=7))
    got = tp(text, mask, pooled, base_init=bn, up_noise=un)
    # stride 4: base latents 8x8 -> 32x32 pixels, resized 4x
    assert seen == [(1, 3, 128, 128)]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tensor_parallel_two_gloo_ranks(tmp_path):
    """tp = 2 over two gloo ranks (tests/_torch_dist_workers.py::
    flux_tp_worker): the trunk and the ControlNet cut to one head a rank,
    the ControlNet's projections whole, TeaCache on; against the
    one-device pipeline at 2e-3, the same decisions."""
    from test_torch_parallel import join, spawn
    import _torch_dist_workers as workers
    _, params, tmod = flux_pair()
    _, cparams, tcn = cn_pair(0.05)
    text, mask, pooled = pipe_inputs()
    bn, un = jax_noise(8)
    kw = dict(UP_KW, enable_teacache=True, rel_l1_thresh=0.8, num_steps=4)
    base_kw, up_kw = (dict(kw, height=hw, width=hw) for hw in (64, 256))
    torch.save(dict(state_dict=flax_to_state_dict(params),
                    cn_state_dict=flax_to_state_dict(cparams),
                    base_kw=base_kw, up_kw=up_kw, text=text, mask=mask,
                    pooled=pooled, base_init=bn, up_noise=un),
               tmp_path / "flux_tp_in.pt")
    ctx = spawn(workers.flux_tp_worker, 2, tmp_path)
    try:
        ref = FluxUpscalePipeline(
            base=FluxPipeline(model=tmod, device="cpu", **base_kw),
            up=FluxPipeline(model=tmod, device="cpu", **up_kw),
            controlnet=tcn)
        want = ref(text, mask, pooled, base_init=bn, up_noise=un)
    finally:
        join(ctx)
    dec = [ref.base.teacache.decisions, ref.up.teacache.decisions]
    assert False in dec[1], dec
    for r in range(2):
        out = torch.load(tmp_path / f"flux_tp_out_{r}.pt", weights_only=False)
        assert out["decisions"] == dec
        assert set(out["heads"]) == {1}
        np.testing.assert_allclose(out["tokens"].numpy(), want.numpy(), **TP)


# ------------------------------------------------------ checkpoint loading

FLUX_JSON = dict(in_channels=8, num_attention_heads=2, attention_head_dim=32,
                 num_layers=1, num_single_layers=1, joint_attention_dim=32,
                 pooled_projection_dim=16, axes_dims_rope=[8, 12, 12],
                 guidance_embeds=True)
CN_JSON = dict(FLUX_JSON, num_layers=2, num_single_layers=0)


@pytest.mark.parametrize("family", ["flux", "flux_controlnet"])
def test_convert_matches_jax(family):
    """On the state dict of tests/manifests/<family>_keys.json (every key
    read by convert_strict), the port's converter straight to its names
    equals JAX's carried through flax_to_state_dict, bit for bit (the
    identity fc1 of the folded embedders, the fused to_qkv, cn_proj_{i});
    the port module loads it strictly; a stray key raises."""
    sd, counts, args, _ = manifests.build_case(family)
    assert set(sd) == manifests.expand_manifest(family, counts)
    got = w.convert_strict(family, {k: t(v) for k, v in sd.items()}, *args)
    want = flax_to_state_dict(jw.CONVERTERS[family](sd, *args))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    module = (FluxDiT(FluxConfig.tiny()) if family == "flux"
              else FluxControlNet(FluxControlNetConfig.tiny()))
    module.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="not consumed"):
        w.convert_strict(family, {**{k: t(v) for k, v in sd.items()},
                                  "stray.weight": torch.zeros(1)}, *args)


def test_flux_config_from_json():
    """Field by field against JAX's parser, with and without the optional
    keys; the text encoders in JAX's order (T5 at 512, then CLIP)."""
    bare = {k: v for k, v in FLUX_JSON.items()
            if k in ("in_channels", "num_attention_heads",
                     "attention_head_dim", "num_layers", "num_single_layers")}
    for c in (FLUX_JSON, bare, {**FLUX_JSON, "out_channels": 4}):
        assert dataclasses.asdict(pre.flux_config_from_json(c)) == \
            dataclasses.asdict(jpre.flux_config_from_json(c))
    assert pre.TEXT_ENCODER_KINDS["flux"] == jpre.TEXT_ENCODER_KINDS["flux"]


def write_flux_snapshot(root, controlnet=True):
    """A tiny fp32 diffusers Flux snapshot: transformer/, a 2-D vae/ (the
    tiny image VAE of stride 2) and, with ``controlnet``, controlnet/ (the
    JAX CLI tests' layout, tests/test_cli.py:46-112)."""
    import test_cli
    test_cli._write_tiny_flux_snapshot(root, with_controlnet=controlnet)
    return root


def test_loaders_match_jax(tmp_path):
    """load_transformer("flux") and load_flux_controlnet on a tiny
    snapshot equal JAX's loads carried across, bit for bit."""
    root = write_flux_snapshot(str(tmp_path))
    jcfg, jparams = jpre.load_transformer("flux", root, dtype="float32",
                                          cache=False)
    cfg, model = pre.load_transformer("flux", root, dtype="float32",
                                      cache=False, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = flax_to_state_dict(jparams)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    cdir = os.path.join(root, "controlnet")
    jccfg, jcp = jpre.load_flux_controlnet(cdir, dtype="float32")
    ccfg, cn = pre.load_flux_controlnet(cdir, dtype="float32", device="cpu")
    assert dataclasses.asdict(ccfg) == dataclasses.asdict(jccfg)
    want = flax_to_state_dict(jcp)
    for k, v in cn.state_dict().items():
        assert torch.equal(v, want[k]), k
    _, bf = pre.load_flux_controlnet(cdir, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.state_dict().values())


# ---------------------------------------------------------------- CLI

def test_cli_random_weights(tmp_path):
    """--model flux-upscale on the CPU with random weights at --scale 0.05
    (128 wide, one head of 128, 1 + 1 blocks, a 1-block ControlNet): base
    32x32, up 128x128; the up stage's tokens and its seconds."""
    from rectified_spaattn_tpu_torch.cli.generate import main
    res = main(["--model", "flux-upscale", "--device", "cpu", "--scale",
                "0.05", "--height", "128", "--width", "128", "--num_steps",
                "2", "--out_dir", str(tmp_path)])
    out = np.load(res["output"])
    assert out.shape == (1, 64, 64) and np.isfinite(out).all()
    # TeaCache off: no decision is made
    assert res["teacache"] == {"skipped": 0, "computed": 0}


@pytest.mark.parametrize("controlnet", [True, False])
def test_cli_ckpt(controlnet, tmp_path):
    """--ckpt_dir: the ControlNet from <ckpt_dir>/controlnet, the control
    through PIXELS (decode, bicubic resize to the upscaled size, encode,
    once), the up stage decoded to an image; without controlnet/ the JAX
    warning and the img2img fallback."""
    from rectified_spaattn_tpu_torch.cli import generate as gen
    root = write_flux_snapshot(str(tmp_path / "snap"), controlnet)
    args = gen.parse_args([
        "--model", "flux-upscale", "--ckpt_dir", root, "--height", "128",
        "--width", "128", "--num_steps", "2", "--device", "cpu",
        "--out_dir", str(tmp_path / "out")])
    args.sa_drop_rate, args.teacache_thresh = gen.DEFAULTS["flux-upscale"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe, inputs, _ = gen.build_flux(args)
    assert (pipe.controlnet is not None) == controlnet
    assert any("ControlNet" in str(x.message) for x in caught) != controlnet
    seen, enc = [], pipe.vae_encode
    pipe.vae_encode = lambda px: seen.append(tuple(px.shape)) or enc(px)
    out = pipe(*inputs)
    # the tiny VAE's stride 2: base latents 4x4 -> 8x8 pixels, 4x up
    assert seen == [(1, 3, 32, 32)]
    assert out.shape == (1, 3, 32, 32) and torch.isfinite(out).all()
    res = gen.main(["--model", "flux-upscale", "--ckpt_dir", root,
                    "--height", "128", "--width", "128", "--num_steps", "2",
                    "--device", "cpu", "--out_dir", str(tmp_path / "out")])
    assert res["output"].endswith(".png") or res["output"].endswith(".npy")
    assert "decode_seconds" in res


@pytest.mark.parametrize("flag", [["--mlp_chunk", "2"],
                                  ["--teacache_residual", "int8"],
                                  ["--teacache_offload"],
                                  ["--replay_trace", "x.json"],
                                  ["--density"],
                                  ["--density", "--scan_blocks"]])
def test_cli_refuses_unported_flags(flag, tmp_path):
    from rectified_spaattn_tpu_torch.cli.generate import main
    with pytest.raises(NotImplementedError, match=flag[0]):
        main(["--model", "flux-upscale", "--device", "cpu", "--scale",
              "0.05", "--height", "64", "--width", "64", "--num_steps", "1",
              "--out_dir", str(tmp_path), *flag])
