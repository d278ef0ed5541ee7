"""The port's HunyuanVideo layers and DiT against the JAX package's Flax
modules, with the Flax parameters bridged by models/convert.py; fp32
rtol 1e-3 / atol 1e-4 (tests/test_models.py:65)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import attention as j_attention
from rectified_spaattn_tpu.models import layers as jl
from rectified_spaattn_tpu.models.hunyuan import (
    HunyuanVideoConfig as JConfig, HunyuanVideoDiT as JDiT)
from rectified_spaattn_tpu.pipelines import build_site as j_build_site
from rectified_spaattn_tpu_torch.attention import attention
from rectified_spaattn_tpu_torch.models import (
    HunyuanVideoConfig, HunyuanVideoDiT, flax_to_state_dict, layers,
    load_flax_params)
from rectified_spaattn_tpu_torch.pipelines import build_site

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-4)
DIM, HEADS = 64, 2


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def bridge(jmod, tmod, *args, seed=0):
    """Init the Flax module on ``args``, load its parameters into the
    port module, and return both outputs as tuples of numpy arrays."""
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), *args))
    load_flax_params(tmod, params)
    want = jmod.apply(params, *args)
    with torch.no_grad():
        got = tmod(*[t(a) if isinstance(a, (np.ndarray, jax.Array)) else a
                     for a in args])
    wrap = lambda o: o if isinstance(o, tuple) else (o,)
    return ([np.asarray(g.detach()) for g in wrap(got)],
            [np.asarray(w) for w in wrap(want)])


def assert_all_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_timestep_embedding():
    ts = np.array([0.0, 3.5, 999.0], np.float32)
    for dim in (256, 33):
        np.testing.assert_allclose(
            layers.timestep_embedding(t(ts), dim).numpy(),
            np.asarray(jl.timestep_embedding(jnp.asarray(ts), dim)), **TOL)


def test_rms_norm():
    x = arr(1, 2, 5, 32)
    assert_all_close(*bridge(jl.RMSNorm(32), layers.RMSNorm(32), x))


@pytest.mark.parametrize("name", ["zero", "single", "continuous"])
def test_ada_layer_norms(name):
    jcls, tcls = {"zero": (jl.AdaLayerNormZero, layers.AdaLayerNormZero),
                  "single": (jl.AdaLayerNormZeroSingle,
                             layers.AdaLayerNormZeroSingle),
                  "continuous": (jl.AdaLayerNormContinuous,
                                 layers.AdaLayerNormContinuous)}[name]
    x, emb = arr(2, 2, 7, DIM), arr(3, 2, DIM)
    assert_all_close(*bridge(jcls(DIM), tcls(DIM), x, emb))


@pytest.mark.parametrize("activation,chunk", [("gelu_tanh", 1),
                                              ("gelu_tanh", 3), ("silu", 1)])
def test_mlp(activation, chunk):
    x = arr(4, 2, 12, DIM)
    assert_all_close(*bridge(jl.MLP(DIM, 4.0, activation, chunk),
                             layers.MLP(DIM, 4.0, activation, chunk), x))


def test_rope():
    pos = tuple(np.arange(6, dtype=np.int32) * i for i in (1, 2, 3))
    cos, sin = layers.rope_axial_freqs(None, (8, 12, 12), tuple(map(t, pos)),
                                       theta=256.0)
    jcos, jsin = jl.rope_axial_freqs(None, (8, 12, 12),
                                     tuple(map(jnp.asarray, pos)), theta=256.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    x = arr(5, 1, 2, 6, 32)
    np.testing.assert_allclose(
        layers.apply_rope_interleaved(t(x), cos, sin).numpy(),
        np.asarray(jl.apply_rope_interleaved(jnp.asarray(x), jcos, jsin)),
        **TOL)


def vanilla_pair():
    return (lambda q, k, v: j_attention(q, k, v, mode="vanilla"),
            lambda q, k, v: attention(q, k, v, mode="vanilla"))


def rope_pair(sv, hd):
    cos, sin = arr(6, sv, hd // 2), arr(7, sv, hd // 2)
    return (jnp.asarray(cos), jnp.asarray(sin)), (t(cos), t(sin))


def test_joint_attention():
    jf, tf = vanilla_pair()
    jr, tr = rope_pair(9, DIM // HEADS)
    x, ctx = arr(8, 2, 9, DIM), arr(9, 2, 4, DIM)
    jmod, tmod = jl.JointAttention(DIM, HEADS), layers.JointAttention(DIM,
                                                                      HEADS)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), x, ctx, jr, jf))
    load_flax_params(tmod, params)
    want = jmod.apply(params, x, ctx, jr, jf)
    with torch.no_grad():
        got = tmod(t(x), t(ctx), tr, tf)
    assert_all_close([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("kind,mlp_chunk", [("dual", 1), ("dual", 2),
                                            ("single", 1), ("single", 3)])
def test_stream_blocks(kind, mlp_chunk):
    jf, tf = vanilla_pair()
    jr, tr = rope_pair(9, DIM // HEADS)
    x, ctx, temb = arr(10, 2, 9, DIM), arr(11, 2, 4, DIM), arr(12, 2, DIM)
    jcls, tcls = ((jl.DualStreamBlock, layers.DualStreamBlock)
                  if kind == "dual" else
                  (jl.SingleStreamBlock, layers.SingleStreamBlock))
    jmod = jcls(DIM, HEADS, 4.0, mlp_chunk=mlp_chunk)
    tmod = tcls(DIM, HEADS, 4.0, mlp_chunk=mlp_chunk)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), x, ctx, temb, jr, jf))
    load_flax_params(tmod, params)
    want = jmod.apply(params, x, ctx, temb, jr, jf)
    with torch.no_grad():
        got = tmod(t(x), t(ctx), t(temb), tr, tf)
    assert_all_close([g.numpy() for g in got], [np.asarray(w) for w in want])


def tiny_pair():
    cfg = JConfig.tiny()
    g = np.random.default_rng(0)
    text = g.normal(size=(1, 128, cfg.text_dim)).astype(np.float32)
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    lat = g.normal(size=(1, cfg.in_channels, 2, 16, 16)).astype(np.float32)
    jmod = JDiT(cfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(lat), jnp.array([0.0]),
        jnp.asarray(text), jnp.asarray(mask), jnp.array([6000.0]),
        None, None))
    tmod = load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()),
                            params)
    return jmod, params, tmod, lat, text, mask


@pytest.mark.parametrize("mode", ["vanilla", "sparse"])
def test_tiny_dit_forward(mode):
    """The whole DiT at tiny() with the curve permutation, in vanilla and
    in sparse mode (the site of build_site at this geometry)."""
    jmod, params, tmod, lat, text, mask = tiny_pair()
    # latent grid 2x16x16, patch 2 -> 2x8x8 tokens: 128 visual tokens
    jsite, jl2h, jh2l = j_build_site(2, 8, 8, sa_drop_rate=0.5, p_remain=0.5,
                                     layout="joint", text_len=128)
    site, l2h, h2l = build_site(2, 8, 8, sa_drop_rate=0.5, p_remain=0.5,
                                layout="joint", text_len=128, device="cpu")
    tlen = np.array([9], np.int32)
    jfn = jsite.attn_fn(mode, text_len_rt=jnp.asarray(tlen), interpret=True)
    tfn = site.attn_fn(mode, text_len_rt=t(tlen))
    args = (np.array([500.0], np.float32), text, mask,
            np.array([6000.0], np.float32))
    want = np.asarray(jmod.apply(
        params, jnp.asarray(lat), *map(jnp.asarray, args),
        hilbert_to_linear=jh2l, linear_to_hilbert=jl2h, attn_fn=jfn))
    with torch.no_grad():
        got = tmod(t(lat), *map(t, args), hilbert_to_linear=h2l,
                   linear_to_hilbert=l2h, attn_fn=tfn).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_is_strict():
    _, params, _, _, _, _ = tiny_pair()
    inner = dict(params["params"])
    sd = flax_to_state_dict(params)
    assert sd["dual_blocks.0.attn.to_q.weight"].shape == (64, 64)
    np.testing.assert_array_equal(
        sd["x_embedder.weight"].numpy(), inner["x_embedder"]["kernel"].T)
    assert "dual_blocks.0.attn.norm_q.weight" in sd      # scale -> weight
    missing = {k: v for k, v in inner.items() if k != "proj_out"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()),
                         {"params": missing})
    extra = {**inner, "extra_head": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="unconsumed"):
        load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()),
                         {"params": extra})
    bad = {**inner, "proj_out": {"kernel": np.zeros((3, 3), np.float32),
                                 "bias": inner["proj_out"]["bias"]}}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()),
                         {"params": bad})
