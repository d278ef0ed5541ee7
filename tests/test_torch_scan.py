"""The port's scan-over-blocks execution (models/scan.py, the pipelines'
``scan_blocks`` / ``dispatch_segments``, the CLI's flags) against the JAX
package on the CPU, as tests/test_scan.py holds JAX's scan against its
unrolled path: the stacked trees bit for bit against JAX's
``stack_block_params`` on the converted tree (pre-stacked and int8 / int4
quantized included), each scan function against JAX's at fp32 rtol 1e-3 /
atol 1e-4 (tests/test_models.py:65), the port's stacked runs against its
unrolled runs bit for bit (the same operations on the same values), a
scan pipeline against JAX's with the same flags, the CLI, tp = 2 on gloo,
the A14B host swap of stacked trees, and ``FlowMatchEulerScheduler
.scale_noise``."""

import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import attention as j_attention
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import scan as jscan
from rectified_spaattn_tpu.models.quant import quantize_params
from rectified_spaattn_tpu_torch.attention import attention
from rectified_spaattn_tpu_torch.models import (flax_to_state_dict,
                                                load_flax_params, quant,
                                                quantize_state_dict, scan)

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-4)


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def vanilla_pair():
    return (lambda q, k, v: j_attention(q, k, v, mode="vanilla"),
            lambda q, k, v: attention(q, k, v, mode="vanilla"))


# ------------------------------------------------------------- the models

@functools.lru_cache(maxsize=None)
def family(name: str):
    """(JAX module, JAX params, port model holding them, JAX config) of a
    tiny model deep enough for the stacks to iterate, and its lists
    {JAX prefix: (port list, depth)}."""
    if name == "hunyuan":
        from rectified_spaattn_tpu.models.hunyuan import (
            HunyuanVideoConfig as JC, HunyuanVideoDiT as JD)
        from rectified_spaattn_tpu_torch.models import (HunyuanVideoConfig,
                                                        HunyuanVideoDiT)
        kw = dict(num_dual_blocks=2, num_single_blocks=3)
        jcfg = dataclasses.replace(JC.tiny(), **kw)
        jmod = JD(jcfg)
        params = jax.jit(jmod.init, static_argnums=(6, 7))(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 2, 8, 8)),
            jnp.array([0.0]), jnp.asarray(arr(1, 1, 16, 32)),
            jnp.ones((1, 16), bool), jnp.array([6000.0]), None, None)
        tmod = HunyuanVideoDiT(dataclasses.replace(HunyuanVideoConfig.tiny(),
                                                   **kw))
        lists = {"dual_": ("dual_blocks", 2), "single_": ("single_blocks", 3)}
    elif name == "flux":
        from rectified_spaattn_tpu.models.flux import (FluxConfig as JC,
                                                       FluxDiT as JD)
        from rectified_spaattn_tpu_torch.models import FluxConfig, FluxDiT
        kw = dict(num_dual_blocks=2, num_single_blocks=3)
        jcfg = dataclasses.replace(JC.tiny(), **kw)
        jmod = JD(jcfg)
        params = jax.jit(jmod.init, static_argnums=(6, 7))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 8)), jnp.array([0.5]),
            jnp.asarray(arr(7, 1, 128, 32)), jnp.asarray(arr(8, 1, 16)),
            jnp.array([3.5]), 8, 8)
        tmod = FluxDiT(dataclasses.replace(FluxConfig.tiny(), **kw))
        lists = {"dual_": ("dual_blocks", 2), "single_": ("single_blocks", 3)}
    elif name == "wan":
        from rectified_spaattn_tpu.models.wan import (WanConfig as JC,
                                                      WanDiT as JD)
        from rectified_spaattn_tpu_torch.models import WanConfig, WanDiT
        jcfg = dataclasses.replace(JC.tiny(), num_blocks=5)
        jmod = JD(jcfg)
        params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 4, 2, 8, 8)),
                                    jnp.zeros((1,)),
                                    jnp.asarray(arr(7, 1, 5, 32)))
        tmod = WanDiT(dataclasses.replace(WanConfig.tiny(), num_blocks=5))
        lists = {"block_": ("blocks", 5)}
    else:
        from rectified_spaattn_tpu.models.cogvideox import (
            CogVideoXConfig as JC, CogVideoXDiT as JD)
        from rectified_spaattn_tpu_torch.models import (CogVideoXConfig,
                                                        CogVideoXDiT)
        jcfg = dataclasses.replace(JC.tiny(), num_blocks=3)
        jmod = JD(jcfg)
        params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 4, 2, 8, 8)),
                                    jnp.zeros((1,)),
                                    jnp.asarray(arr(7, 1, 5, 32)))
        tmod = CogVideoXDiT(dataclasses.replace(CogVideoXConfig.tiny(),
                                                num_blocks=3))
        lists = {"block_": ("blocks", 3)}
    params = np_tree(params)
    return jmod, params, load_flax_params(tmod, params), jcfg, lists


def stacked_model(name: str):
    """A fresh port model of ``family(name)`` with its lists stacked."""
    jmod, params, _, jcfg, lists = family(name)
    tmod = load_flax_params(type(family(name)[2])(family(name)[2].cfg),
                            params)
    return tmod, scan.stack_model_blocks(tmod, *(n for n, _ in
                                                  lists.values()))


def jax_stacked(params, lists):
    inner = dict(params["params"])
    out = {}
    for prefix, (port, n) in lists.items():
        inner, out[port] = jscan.stack_block_params(inner, prefix, n)
    return inner, out


# ------------------------------------------------------------ the trees

_COLLECTION = {"dual_blocks": "scan_dual", "single_blocks": "scan_single",
               "blocks": "scan_blocks"}


@pytest.mark.parametrize("name,bits", [("hunyuan", 0), ("hunyuan", 8),
                                       ("hunyuan", 4), ("flux", 4),
                                       ("wan", 0), ("cogvideox", 8)])
def test_stacked_trees_match_jax(name, bits):
    """The port's stack_block_params on the converted (and, for bits,
    quantize_state_dict'ed) tree equals JAX's stack_block_params (then
    quantize_params) through flax_to_state_dict's pre-stacked path, key
    for key and bit for bit; load_flax_params takes the pre-stacked tree
    into the same model state as the unstacked one."""
    _, params, _, _, lists = family(name)
    qkw = dict(bits=bits, min_size=1, group_size=32)
    inner, stacks = jax_stacked(params, lists)
    pre = {"params": inner,
           **{_COLLECTION[port]: st for port, st in stacks.items()}}
    if bits:
        pre = quantize_params(pre, **qkw)
    want = flax_to_state_dict(pre)
    sd = flax_to_state_dict(params)
    if bits:
        sd = quantize_state_dict(sd, **qkw)
    n_leaves = len(sd)
    got = {}
    for port, n in lists.values():
        sd, st = scan.stack_block_params(sd, f"{port}.", n)
        got.update({f"{port}.{k}": v for k, v in st.items()})
        assert all(v.shape[0] == n for v in st.values())
    got.update(sd)                       # the rest, the block entries gone
    assert sorted(got) == sorted(want)
    assert len(got) < n_leaves
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    if bits:
        assert any(k.endswith("weight_q4" if bits == 4 else "weight_q")
                   for k in got)
    # the pre-stacked tree loads into the per-block modules
    ref = type(family(name)[2])(family(name)[2].cfg)
    a = load_flax_params(ref, quantize_params(params, **qkw) if bits
                         else params).state_dict()
    b = load_flax_params(type(ref)(ref.cfg), pre).state_dict()
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
               for k in a)


def test_unstack_views_and_strict_stacking():
    """unstack_block_params gives views of the stacks, equal to the
    blocks' leaves; stacking refuses a missing block or blocks whose
    leaves differ."""
    _, params, tmod, _, _ = family("wan")
    sd = dict(tmod.state_dict())
    full = dict(sd)
    rest, st = scan.stack_block_params(sd, "blocks.", 5)
    assert rest is sd and not any(k.startswith("blocks.") for k in rest)
    back = scan.unstack_block_params(st, "blocks.")
    assert sorted(back) == sorted(k for k in full if k.startswith("blocks."))
    for k, v in back.items():
        assert torch.equal(v, full[k])
        name = k.split(".", 2)[2]
        assert v.untyped_storage().data_ptr() == \
            st[name].untyped_storage().data_ptr()
    with pytest.raises(KeyError, match="missing"):
        scan.stack_block_params(dict(full), "blocks.", 6)
    bad = dict(full)
    del bad["blocks.2.norm2.bias"]
    with pytest.raises(KeyError, match="other leaves"):
        scan.stack_block_params(bad, "blocks.", 5)


def _storage_bytes(model) -> int:
    seen = {}
    for t in [*model.parameters(), *model.buffers()]:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def test_block_stack_holds_one_copy():
    """Stacking an int4 / int8 / dense model keeps one copy of its weights:
    the blocks' leaves become views of the stacks and keep their QLinear
    layouts;
    a model stacked again reuses its stacks until the blocks change
    (quantized after stacking: stacked anew); ``bind`` is strict."""
    _, params, _, _, _ = family("hunyuan")
    tmod = load_flax_params(type(family("hunyuan")[2])(
        family("hunyuan")[2].cfg), params)
    quant.quantize_model(tmod, bits=4, min_size=1, group_size=32,
                         skip=("single_blocks",))
    quant.quantize_model(tmod, bits=8, min_size=1, skip=("proj_out",))
    before = _storage_bytes(tmod)
    dual, single = scan.stack_model_blocks(tmod, "dual_blocks",
                                           "single_blocks")
    assert _storage_bytes(tmod) == before
    assert sum(t.untyped_storage().nbytes() for st in (dual, single)
               for t in st.params.values()) == \
        sum(t.numel() * t.element_size() for k, t in tmod.state_dict().items()
            if k.startswith(("dual_blocks.", "single_blocks.")))
    assert tmod.dual_blocks[1].attn.to_q.weight_q4.data_ptr() == \
        dual.params["attn.to_q.weight_q4"][1].data_ptr()
    assert dual.blocks[0].attn.to_q.layout == "int4"
    assert single.blocks[0].to_qkv.layout == "int8"
    assert single.blocks[0].proj_out.layout == "dense"
    assert "attn.to_q.weight_q4" in dual.params
    assert dual.is_bound() and single.is_bound()
    assert scan.stack_model_blocks(tmod, "dual_blocks")[0] is dual
    # a change after stacking: the next pipeline stacks again
    quant.quantize_model(tmod, bits=8, min_size=1)
    assert not single.is_bound()
    again = scan.stack_model_blocks(tmod, "single_blocks")[0]
    assert again is not single and again.is_bound()
    with pytest.raises(KeyError, match="missing"):
        dual.bind({k: v for k, v in dual.params.items()
                   if not k.endswith("scale")})
    with pytest.raises(KeyError, match="unconsumed"):
        dual.bind({**dual.params, "extra.weight": dual.params[
            "attn.to_q.bias"]})
    with pytest.raises(ValueError, match="want"):
        dual.bind({k: v[:1] for k, v in dual.params.items()})


# -------------------------------------------------- the scan functions

def _hunyuan_inputs(jmod, params):
    from rectified_spaattn_tpu.models.hunyuan import HunyuanVideoDiT as JD
    out = jmod.apply(params, jnp.asarray(arr(3, 1, 4, 2, 8, 8)),
                     jnp.array([500.0]), jnp.asarray(arr(4, 1, 16, 32)),
                     jnp.ones((1, 16), bool), jnp.array([6000.0]), None,
                     None, method=JD.embed)
    return jax.tree_util.tree_map(np.asarray, out)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def test_hunyuan_scan_functions_match_jax():
    """hunyuan_run_blocks_scan (also under token_replace's temb_alt /
    alt_mask), hunyuan_run_phase_scan over windows and
    hunyuan_teacache_signal_scan against JAX's on the same inputs; the
    port's stacked run equals its unrolled run_blocks bit for bit."""
    jmod, params, tmod, jcfg, lists = family("hunyuan")
    smod, (dual, single) = stacked_model("hunyuan")
    jfn, tfn = vanilla_pair()
    x, ctx, temb, rope = _hunyuan_inputs(jmod, params)
    inner, js = jax_stacked(params, lists)
    jd, jsg = js["dual_blocks"], js["single_blocks"]
    alt = np.zeros(x.shape[1], bool)
    alt[::3] = True
    temb_alt = arr(5, *temb.shape)
    for extra in ((), (temb_alt, alt)):
        want = jscan.hunyuan_run_blocks_scan(jcfg, jd, jsg, x, ctx, temb,
                                             rope, jfn, *extra)
        got = scan.hunyuan_run_blocks_scan(tmod.cfg, dual, single,
                                           *_t((x, ctx, temb, rope)), tfn,
                                           *_t(extra))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        unrolled = smod.run_blocks(*_t((x, ctx, temb, rope)), tfn,
                                   *_t(extra))
        assert all(torch.equal(a, b) for a, b in zip(got, unrolled))
    # a window of each phase: dual block [1, 2), single blocks [1, 3)
    for phase, jst, st, start, size in (("dual", jd, dual, 1, 1),
                                        ("single", jsg, single, 1, 2)):
        want = jscan.hunyuan_run_phase_scan(jcfg, jst, phase, x, ctx, temb,
                                            rope, jfn, jnp.int32(start),
                                            size)
        got = scan.hunyuan_run_phase_scan(tmod.cfg, st, phase,
                                          *_t((x, ctx, temb, rope)), tfn,
                                          start, size)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want = jscan.hunyuan_teacache_signal_scan(jcfg, jd, x, temb)
    got = scan.hunyuan_teacache_signal_scan(tmod.cfg, dual, *_t((x, temb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, smod.teacache_signal(*_t((x, temb))))


def test_wan_scan_functions_match_jax():
    """wan_run_blocks_scan over warm-gate segments (dense, sparse-stand-in,
    dense) and wan_run_window_scan against JAX's; the stacked run equals
    the unrolled run_blocks bit for bit."""
    from rectified_spaattn_tpu.models.wan import WanDiT as JD
    jmod, params, tmod, jcfg, lists = family("wan")
    smod, (stack,) = stacked_model("wan")
    jfn, tfn = vanilla_pair()
    # a second self-attention function (the sparse stand-in): scaled keys
    jfn2 = lambda q, k, v: j_attention(q, 0.5 * k, v, mode="vanilla")
    tfn2 = lambda q, k, v: attention(q, 0.5 * k, v, mode="vanilla")
    x, ctx, ctx_img, temb, temb6, rope = jax.tree_util.tree_map(
        np.asarray, jmod.apply(params, jnp.asarray(arr(3, 1, 4, 2, 8, 8)),
                               jnp.array([300.0]),
                               jnp.asarray(arr(4, 1, 5, 32)), None,
                               method=JD.embed))
    inner, js = jax_stacked(params, lists)
    jst = js["blocks"]
    segs = lambda d, s: [(0, 1, d), (1, 4, s), (4, 5, d)]
    want = jscan.wan_run_blocks_scan(jcfg, jst, x, ctx, None, temb6, rope,
                                     segs(jfn, jfn2), jfn)
    args = _t((x, ctx))
    got = scan.wan_run_blocks_scan(tmod.cfg, stack, *args, None,
                                   *_t((temb6, rope)), segs(tfn, tfn2), tfn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    unrolled = smod.run_blocks(*args, None, *_t((temb6, rope)), tfn, tfn,
                               [tfn, tfn2, tfn2, tfn2, tfn])
    assert torch.equal(got, unrolled)
    want = jscan.wan_run_window_scan(jcfg, jst, x, ctx, None, temb6, rope,
                                     jfn2, jfn, jnp.int32(2), 2)
    got = scan.wan_run_window_scan(tmod.cfg, stack, *args, None,
                                   *_t((temb6, rope)), tfn2, tfn, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flux_and_cog_scan_functions_match_jax():
    """flux_run_blocks_scan with gate segments and the RAW ControlNet
    sample lists (2 dual samples over 2 blocks, 2 single samples over 3),
    and cog_run_blocks_scan, against JAX's; each stacked run equals the
    unrolled run_blocks bit for bit; gate_segments collapses by identity
    as JAX's does."""
    from rectified_spaattn_tpu.models.flux import FluxDiT as JD
    jmod, params, tmod, jcfg, lists = family("flux")
    smod, (dual, single) = stacked_model("flux")
    jfn, tfn = vanilla_pair()
    jfn2 = lambda q, k, v: j_attention(q, 0.5 * k, v, mode="vanilla")
    tfn2 = lambda q, k, v: attention(q, 0.5 * k, v, mode="vanilla")
    x, ctx, temb, rope = jax.tree_util.tree_map(np.asarray, jmod.apply(
        params, jnp.asarray(arr(3, 1, 64, 8)), jnp.array([0.6]),
        jnp.asarray(arr(4, 1, 128, 32)), jnp.asarray(arr(5, 1, 16)),
        jnp.array([3.5]), 8, 8, None, method=JD.embed))
    cn_d = [arr(10 + i, *x.shape) for i in range(2)]
    cn_s = [arr(20 + i, *x.shape) for i in range(2)]
    gate = lambda d, s: (lambda i: s if i in (1, 3) else d)
    for gs in (jscan.gate_segments, scan.gate_segments):
        assert [(a, b) for a, b, _ in gs(5, gate("d", "s"))] == \
            [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
        assert gs(4, lambda i: "d") == [(0, 4, "d")]
    jg, tg = gate(jfn, jfn2), gate(tfn, tfn2)
    inner, js = jax_stacked(params, lists)
    want = jscan.flux_run_blocks_scan(
        jcfg, js["dual_blocks"], js["single_blocks"], x, ctx, temb, rope,
        jscan.gate_segments(2, jg),
        jscan.gate_segments(3, lambda i: jg(2 + i)),
        cn_d, cn_s)
    dsegs = scan.gate_segments(2, tg)
    ssegs = scan.gate_segments(3, lambda i: tg(2 + i))
    got = scan.flux_run_blocks_scan(tmod.cfg, dual, single,
                                    *_t((x, ctx, temb, rope)), dsegs, ssegs,
                                    _t(cn_d), _t(cn_s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    from rectified_spaattn_tpu_torch.models import (
        distribute_controlnet_samples as dist)
    unrolled = smod.run_blocks(*_t((x, ctx, temb, rope)), None,
                               [tg(i) for i in range(2)],
                               [tg(2 + i) for i in range(3)],
                               dist(_t(cn_d), 2), dist(_t(cn_s), 3))
    assert all(torch.equal(a, b) for a, b in zip(got, unrolled))

    from rectified_spaattn_tpu.models.cogvideox import CogVideoXDiT as JC
    jmod, params, tmod, jcfg, lists = family("cogvideox")
    smod, (stack,) = stacked_model("cogvideox")
    x, ctx, temb, rope = jax.tree_util.tree_map(np.asarray, jmod.apply(
        params, jnp.asarray(arr(3, 1, 4, 2, 8, 8)), jnp.array([300.0]),
        jnp.asarray(arr(4, 1, 5, 32)), None, method=JC.embed))
    inner, js = jax_stacked(params, lists)
    want = jscan.cog_run_blocks_scan(jcfg, js["blocks"], x, ctx, temb, rope,
                                     jfn)
    got = scan.cog_run_blocks_scan(tmod.cfg, stack, *_t((x, ctx, temb, rope)),
                                   tfn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    unrolled = smod.run_blocks(*_t((x, ctx, temb, rope)), tfn)
    assert all(torch.equal(a, b) for a, b in zip(got, unrolled))


# ------------------------------------------------------------ the pipelines

def fresh(name: str, **cfg_kw):
    """A new port model of ``family(name)`` holding its weights."""
    _, params, tmod, _, _ = family(name)
    return load_flax_params(type(tmod)(dataclasses.replace(tmod.cfg,
                                                           **cfg_kw)),
                            params)


def count_calls(monkeypatch, name: str) -> list:
    """Record the results of ``scan.<name>``'s calls (the pipelines look it
    up on the module at each call)."""
    calls, orig = [], getattr(scan, name)

    def counted(*a, **kw):
        calls.append(orig(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(scan, name, counted)
    return calls


HUN_KW = dict(height=64, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="sparse", enable_teacache=True,
              rel_l1_thresh=0.8, text_len=128, group_rows=2,
              density_probe=True)


def hunyuan_inputs():
    g = np.random.default_rng(4)
    text = np.zeros((1, 128, 32), np.float32)
    text[:, :9] = g.normal(size=(1, 9, 32))
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    return text, mask, g.normal(size=(1, 4, 2, 8, 16)).astype(np.float32)


@pytest.mark.parametrize("i2v", [False, True])
def test_hunyuan_pipeline_scan_and_windows_equal_unrolled(i2v, monkeypatch):
    """The tiny 2 + 3-block pipeline, sparse at G = 2, TeaCache on with a
    skip, the density probe on (and token_replace I2V with its first frame
    held): stacked in one pass and in 2 and 3 windows a phase, each equal
    to the unrolled run bit for bit, decisions and densities too; every
    k runs the one stacked pass a computed step; windows without
    scan_blocks raise as JAX asserts."""
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline
    text, mask, init = hunyuan_inputs()
    cfg_kw = dict(image_condition_type="token_replace") if i2v else {}
    extra = dict(first_frame=arr(6, 1, 4, 1, 8, 16)) if i2v else {}
    mk = lambda model, **kw: HunyuanVideoPipeline(
        model=model, device="cpu", **HUN_KW, **kw)
    ref = mk(fresh("hunyuan", **cfg_kw))
    want = ref(text, mask, init_latents=init, **extra)
    assert False in ref.teacache.decisions       # the skip path ran
    model = fresh("hunyuan", **cfg_kw)
    one_pass = count_calls(monkeypatch, "hunyuan_run_blocks_scan")
    computed = sum(ref.teacache.decisions)
    for k in (1, 2, 3):
        one_pass.clear()
        pipe = mk(model, scan_blocks=True, dispatch_segments=k)
        got = pipe(text, mask, init_latents=init, **extra)
        assert torch.equal(got, want), k
        assert pipe.teacache.decisions == ref.teacache.decisions
        assert pipe.density_samples == ref.density_samples
        assert len(one_pass) == computed, k
    with pytest.raises(ValueError, match="requires scan_blocks"):
        mk(fresh("hunyuan"), dispatch_segments=2)


WAN_KW = dict(height=128, width=128, frames=5, num_steps=3,
              sa_drop_rate=0.5, p_remain_rates=0.5, mode="sparse",
              enable_teacache=True, teacache_thresh=0.3, warm_layers=1,
              warm_last_layers=1, warm_calls=2, density_probe=True)


def test_wan_pipeline_scan_and_windows_equal_unrolled(monkeypatch):
    """The tiny 5-block Wan pipeline (warm gates dense [0, 1), sparse
    [1, 4), dense [4, 5); the first step dense), TeaCache on with a
    skip, the probe on: stacked in one pass and in 2 and 3 windows a
    segment, each equal to the unrolled run bit for bit and each the one
    stacked pass a computed call; windows without scan_blocks raise."""
    from rectified_spaattn_tpu_torch.pipelines import WanPipeline
    g = np.random.default_rng(14)
    mk = lambda model, **kw: WanPipeline(model=model, device="cpu",
                                         **WAN_KW, **kw)
    ref = mk(fresh("wan"))
    init = g.normal(size=(1, 4, *ref.grid)).astype(np.float32)
    text_c = g.normal(size=(1, 6, 32)).astype(np.float32)
    text_u = np.zeros_like(text_c)
    want = ref.denoise(init, text_c, text_u)
    assert False in ref.teacache.decisions
    model = fresh("wan")
    passes = count_calls(monkeypatch, "wan_run_blocks_scan")
    computed = sum(ref.teacache.decisions)
    for k in (1, 2, 3):
        passes.clear()
        pipe = mk(model, scan_blocks=True, dispatch_segments=k)
        got = pipe.denoise(init, text_c, text_u)
        assert torch.equal(got, want), k
        assert pipe.teacache.decisions == ref.teacache.decisions
        assert pipe.density_samples == ref.density_samples
        assert len(passes) == computed, k
    with pytest.raises(ValueError, match="requires scan_blocks"):
        mk(fresh("wan"), dispatch_segments=2)


def test_cog_pipeline_scan_equals_unrolled():
    """The tiny 3-block CogVideoX pipeline (dense calls, then sparse from
    call 2, TeaCache on with the signal scaled into range): stacked equal
    to unrolled bit for bit, decisions and sparse calls too."""
    from rectified_spaattn_tpu_torch.pipelines import CogVideoXPipeline
    g = np.random.default_rng(3)
    kw = dict(height=128, width=192, frames=25, num_steps=4,
              sa_drop_rate=0.5, p_remain_rates=0.5, teacache_thresh=0.1,
              teacache_signal_scale=0.1, text_len=128, mode="sparse",
              enable_teacache=True, sparse_warm_calls=2, group_rows=2)
    init = g.normal(size=(1, 4, 4, 16, 24)).astype(np.float32)
    text_c = np.zeros((1, 128, 32), np.float32)
    text_c[:, :5] = g.normal(size=(1, 5, 32))
    runs = []
    for scan_blocks in (False, True):
        pipe = CogVideoXPipeline(model=fresh("cogvideox"), device="cpu",
                                 scan_blocks=scan_blocks, **kw)
        runs.append((pipe.denoise(init, text_c, np.zeros_like(text_c)),
                     pipe.teacache.decisions, pipe.sparse_calls))
    assert runs[0][2] and False in runs[0][1]
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1:] == runs[1][1:]


def test_flux_upscale_scan_equals_unrolled():
    """The tiny 2 + 3-block Flux upscale (base 64^2, up 256^2) under the
    gate (1, 3) (dual: sparse, dense; single: dense, sparse, sparse) with
    a nudged 2-block ControlNet and TeaCache on: stacked (both stages on
    one set of stacks, the ControlNet unrolled) equal to unrolled bit
    for bit."""
    from rectified_spaattn_tpu_torch.models import (FluxControlNet,
                                                    FluxControlNetConfig,
                                                    init_controlnet_weights)
    from rectified_spaattn_tpu_torch.pipelines import (FluxPipeline,
                                                       FluxUpscalePipeline)
    g = np.random.default_rng(13)
    text = np.zeros((1, 128, 32), np.float32)
    text[:, :7] = g.normal(size=(1, 7, 32))
    mask = np.zeros((1, 128), bool)
    mask[:, :7] = True
    pooled = g.normal(size=(1, 16)).astype(np.float32)
    base = g.normal(size=(1, 16, 8)).astype(np.float32)
    up = g.normal(size=(1, 256, 8)).astype(np.float32)
    gen = torch.Generator()
    gen.manual_seed(21)
    cn = init_controlnet_weights(FluxControlNet(FluxControlNetConfig.tiny()),
                                 gen, nudge=0.05)
    kw = dict(num_steps=2, sa_drop_rate=0.5, p_remain_rates=0.5,
              mode="sparse", text_len=128, enable_teacache=True,
              rel_l1_thresh=0.8, sparse_layer_gate=(1, 3), device="cpu")
    runs = []
    for scan_blocks in (False, True):
        model = fresh("flux")
        pipe = FluxUpscalePipeline(
            base=FluxPipeline(model=model, height=64, width=64,
                              scan_blocks=scan_blocks, **kw),
            up=FluxPipeline(model=model, height=256, width=256,
                            scan_blocks=scan_blocks, **kw), controlnet=cn)
        runs.append(pipe(text, mask, pooled, base_init=base, up_noise=up))
        if scan_blocks:
            assert pipe.base.stacks is not None
            assert all(a is b for a, b in zip(pipe.base.stacks,
                                              pipe.up.stacks))
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("mode,tea", [
    ("vanilla", False), ("vanilla", True),
    # JAX's Pallas kernels in interpret mode, one program a window: ~30 s
    pytest.param("sparse", False, marks=pytest.mark.slow)])
def test_hunyuan_scan_pipeline_matches_jax(mode, tea, tmp_path):
    """The tiny 2 + 3-block pipeline with scan_blocks and
    dispatch_segments 2 against JAX's pipeline with the same flags, from
    the same noise.  TeaCache off: latents within fp32 1e-3 / 1e-4 (the
    sparse case under ``slow``; test_torch_pipeline.py holds the sparse
    pipelines unrolled, and the port's stacked runs equal its unrolled
    ones bit for bit).  TeaCache on: the decisions call for call (the
    middle call skips) and the latents within the bf16 tolerance 2e-2, as
    tests/test_torch_cogvideox.py holds its TeaCache runs: the skipped
    call adds the residual stored in bf16 (the reference's format, on both
    sides), and an element whose fp32 residual straddles a bf16 rounding
    midpoint rounds one bf16 step apart in the two packages (4e-4 on one
    of 1,024 latents at 3 + 4 blocks, sparse; the unrolled pipelines
    differ the same)."""
    from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JPipe
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline
    jmod, params, _, _, _ = family("hunyuan")
    text, mask, init = hunyuan_inputs()
    kw = {k: v for k, v in HUN_KW.items() if k != "density_probe"}
    kw.update(scan_blocks=True, dispatch_segments=2, enable_teacache=tea,
              mode=mode)
    jpipe = JPipe(model=jmod, params=params, interpret=True, **kw)
    trace = tmp_path / "trace.json"
    with jtc.trace_to(str(trace)):
        want = np.asarray(jpipe(jnp.asarray(text), jnp.asarray(mask),
                                init_latents=jnp.asarray(init)))
    jdec = [r["compute"] for r in json.loads(trace.read_text())
            if "call" in r]
    pipe = HunyuanVideoPipeline(model=fresh("hunyuan"), device="cpu", **kw)
    got = pipe(text, mask, init_latents=init).numpy()
    assert pipe.teacache.decisions == jdec
    assert (False in jdec) == tea
    np.testing.assert_allclose(got, want, **(dict(rtol=2e-2, atol=2e-2)
                                             if tea else TOL))


# ---------------------------------------------------- the CLI, run_eval

CLI = ["--device", "cpu", "--scale", "0.1", "--height", "64", "--width",
       "64", "--frame", "8", "--num_steps", "2", "--enable_teacache",
       "--group_rows", "2"]


def test_cli_serving_tier_and_refusals(tmp_path, monkeypatch):
    """``--scan_blocks --quant 8 --dispatch_segments 2`` (quantized with
    min_size 1, so every block layer is int8) equals the unrolled
    ``--quant 8`` run bit for bit; ``--dispatch_segments`` alone is
    ignored, as the JAX CLI ignores it; the levers JAX's CogVideoX and
    Flux pipelines lack stay refused under --scan_blocks; run_eval's
    --scan_blocks reaches the stacked path."""
    from rectified_spaattn_tpu_torch.cli.generate import main
    monkeypatch.setattr(quant, "quantize_model", functools.partial(
        quant.quantize_model, min_size=1))
    passes = count_calls(monkeypatch, "hunyuan_run_blocks_scan")
    outs = {}
    for name, flags in (("unrolled", ["--quant", "8"]),
                        ("ignored", ["--quant", "8", "--dispatch_segments",
                                     "2"]),
                        ("serving", ["--scan_blocks", "--quant", "8",
                                     "--dispatch_segments", "2"])):
        passes.clear()
        res = main(CLI + flags + ["--out_dir", str(tmp_path / name)])
        outs[name] = np.load(res["output"])
        # 2 computed steps, each one stacked pass under --scan_blocks
        assert len(passes) == (2 if name == "serving" else 0)
    np.testing.assert_array_equal(outs["serving"], outs["unrolled"])
    np.testing.assert_array_equal(outs["ignored"], outs["unrolled"])
    for model, flag in (("cogvideox-t2v", ["--density"]),
                        ("flux-upscale", ["--mlp_chunk", "2"])):
        with pytest.raises(NotImplementedError, match=flag[0]):
            main(["--model", model, "--device", "cpu", "--scan_blocks",
                  *flag])
    from rectified_spaattn_tpu_torch.eval import run_eval
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\n")
    passes.clear()
    run_eval.main(["--model", "hunyuan", "--device", "cpu", "--prompts",
                   str(prompts), "--height", "64", "--width", "64",
                   "--frame", "8", "--num_steps", "1", "--scan_blocks",
                   "--dispatch_segments", "2",
                   "--out_dir", str(tmp_path / "eval")])
    assert len(passes) == 1                      # the one step, stacked


def test_tensor_parallel_scan_on_two_gloo_ranks(tmp_path):
    """At tp = 2 on gloo: the tiny HunyuanVideo (int8 QLinears) and Wan
    pipelines sharded, then stacked (the stacks hold the row-parallel
    parts and the sharded norms), equal to the unrolled tp = 2 run on
    each rank bit for bit."""
    import os
    import torch.multiprocessing as mp
    from _torch_dist_workers import scan_tp_worker
    _, hparams, _, _, _ = family("hunyuan")
    _, wparams, _, _, _ = family("wan")
    text, mask, init = hunyuan_inputs()
    torch.save({"hunyuan": flax_to_state_dict(hparams),
                "wan": flax_to_state_dict(wparams), "text": text,
                "mask": mask, "init": init}, tmp_path / "scan_tp_in.pt")
    mp.start_processes(scan_tp_worker, args=(2, str(tmp_path)), nprocs=2,
                       join=True, start_method="spawn")
    for rank in range(2):
        out = torch.load(os.path.join(tmp_path, f"scan_tp_out_{rank}.pt"))
        for name in ("hunyuan", "wan"):
            assert torch.equal(out[name]["scan"], out[name]["unrolled"])
            assert out[name]["sharded_leaves"], name
        assert out["hunyuan"]["int8_leaves"] and out["wan"]["sharded_norms"]


# ------------------------------------------------ A14B, the scheduler

def test_a14b_host_swap_of_stacked_trees():
    """Wan2.2 A14B with host_swap on stacked trees (scan_blocks,
    dispatch_segments=2) equals the co-resident unrolled run bit for bit, twice in
    a row; each swapped tree is one tree's bytes (each stack once); the
    freed tree holds no memory (its model and its stacks on meta)."""
    from rectified_spaattn_tpu_torch.pipelines import (Wan22A14BPipeline,
                                                       WanPipeline)
    kw = dict(height=128, width=128, frames=5, num_steps=4, mode="sparse",
              sa_drop_rate=0.5, p_remain_rates=0.5, warm_layers=1,
              warm_last_layers=1, scheduler="euler", device="cpu")
    g = np.random.default_rng(2)
    text = g.normal(size=(1, 6, 32)).astype(np.float32)
    neg = np.zeros_like(text)
    models = [fresh("wan"), fresh("wan")]
    with torch.no_grad():
        for p in models[1].parameters():
            p.mul_(0.9)                          # a second, different tree
    one_tree = [sum(t.numel() * t.element_size()
                    for t in m.state_dict().values()) for m in models]
    co = Wan22A14BPipeline(high=WanPipeline(model=models[0], **kw),
                           low=WanPipeline(model=models[1], **kw),
                           boundary_ratio=0.7)
    init = g.normal(size=(1, 4, *co.high.grid)).astype(np.float32)
    want = co(text, neg, init_latents=init)
    skw = dict(kw, scan_blocks=True, dispatch_segments=2, defer_device=True)
    swap = Wan22A14BPipeline(
        high=WanPipeline(model=fresh("wan"), **skw),
        low=WanPipeline(model=models[1], **skw),
        boundary_ratio=0.7, host_swap=True)
    for _ in range(2):
        got = swap(text, neg, init_latents=init)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert all(p.is_meta for p in swap.high.model.parameters())
        assert all(t.is_meta for t in swap.high.stack.params.values())
        assert not any(p.is_meta for p in swap.low.model.parameters())
        assert swap.low.stack.is_bound()
    trees = [sum(t.numel() * t.element_size() for t in tree.values())
             for tree in swap._host]
    assert trees == one_tree
    assert any(k.startswith("blocks.") and not k.split(".")[1].isdigit()
               for k in swap._host[0])


def test_scale_noise_matches_jax():
    from rectified_spaattn_tpu.pipelines import schedulers as jsched
    from rectified_spaattn_tpu_torch.pipelines import FlowMatchEulerScheduler
    x, n = arr(0, 2, 3, 4), arr(1, 2, 3, 4)
    for kw in (dict(num_steps=5), dict(num_steps=4, use_mu=True, mu=1.2)):
        ours = FlowMatchEulerScheduler(**kw)
        ref = jsched.FlowMatchEulerScheduler(**kw)
        for i in range(kw["num_steps"]):
            np.testing.assert_allclose(
                ours.scale_noise(torch.from_numpy(x), torch.from_numpy(n),
                                 i).numpy(),
                np.asarray(ref.scale_noise(jnp.asarray(x), jnp.asarray(n),
                                           i)), rtol=2e-6, atol=1e-7)
