"""The port's int8 levers against the JAX package on the CPU: the int8 K|V
payload (quantize_kv_blocks, bit for bit), the K1q plain version in both
modes against the Pallas kernel in interpret mode, the attention site with
kv_quant, QLinear / quantize_model / quantize_state_dict against QDense /
quantize_params, the weight bridge on a quantized tree, the int8 and
offloaded TeaCache residual, the tiny HunyuanVideo and Wan pipelines with
quantized weights and the int8, offloaded residual, the CLI flags, and S1's
plain version against the Pallas ``_loop_kernel`` in interpret mode.

Tolerances: integers and quantized values exact; the K1q plain version at
fp32 rtol 2e-4 / atol 2e-5 (tests/test_kernels.py); the attention site at
2e-3 (tests/test_attention.py); layers and pipelines at 1e-3 / 1e-4
(tests/test_models.py); TeaCache decisions identical call for call."""

import functools
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu import kernels as jk
from rectified_spaattn_tpu.attention import rectified_sparse_attention as j_rsa
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import quant as jq
from rectified_spaattn_tpu.models.hunyuan import (
    HunyuanVideoConfig as JHConfig, HunyuanVideoDiT as JHDiT)
from rectified_spaattn_tpu.models.wan import WanConfig as JWConfig
from rectified_spaattn_tpu.models.wan import WanDiT as JWDiT
from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JHPipe
from rectified_spaattn_tpu.pipelines import WanPipeline as JWPipe
from rectified_spaattn_tpu.sparse import SparseConfig as JConfig
from rectified_spaattn_tpu.sparse import ops as jops
from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.attention import rectified_sparse_attention
from rectified_spaattn_tpu_torch.cache import TeaCache, teacache
from rectified_spaattn_tpu_torch.cli import generate
from rectified_spaattn_tpu_torch.kernels import int8_probe
from rectified_spaattn_tpu_torch.models import (
    HunyuanVideoConfig, HunyuanVideoDiT, WanConfig, WanDiT, load_flax_params,
    quant)
from rectified_spaattn_tpu_torch.pipelines import (HunyuanVideoPipeline,
                                                   WanPipeline)
from rectified_spaattn_tpu_torch.sparse import SparseConfig, ops

torch.set_num_threads(1)
BM = BN = 128
F32 = dict(rtol=2e-4, atol=2e-5)
SITE = dict(rtol=2e-3, atol=2e-3)
TOL = dict(rtol=1e-3, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_quantize_kv_blocks_bit_exact():
    """Per-(batch, head, key block) absmax int8 of K and V, including an
    all-zero block (its denominator is 1) and a block of one value."""
    k, v = arr(1, 2, 3, 4 * BN, 32), arr(2, 2, 3, 4 * BN, 32) * 3.0
    k[0, 1, BN:2 * BN] = 0.0
    v[1, 2, 3 * BN:] = -0.25
    got = ops.quantize_kv_blocks(torch.from_numpy(k), torch.from_numpy(v), BN)
    want = jops.quantize_kv_blocks(jnp.asarray(k), jnp.asarray(v), BN)
    assert got[0].dtype == torch.int8 and got[0].shape == (6, 4 * BN, 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def k1q_case(seed):
    """One head of 3 row blocks over 6 key blocks: [5 visual blocks (the
    last 40 tokens padding) | 1 text block], B=2 with text_len 70 and 0, a
    zero-count row and a row whose only block is batch 1's masked text
    block (degenerate)."""
    b, h, nq, nb, d = 2, 1, 3, 6, 64
    q, k, v = arr(seed, b, h, nq * BM, d), arr(seed + 1, b, h, nb * BN, d), \
        arr(seed + 2, b, h, nb * BN, d)
    mask = np.random.default_rng(seed + 3).uniform(size=(b, h, nq, nb)) < 0.6
    mask[..., 0] = True
    mask[0, 0, 2] = False                     # count 0
    mask[1, 0, 1] = False
    mask[1, 0, 1, 5] = True                   # only the masked text block
    tlen = np.array([70, 0], np.int32)
    # K/V are not zeroed at the masked keys, so the degenerate row's
    # average over its chunk's lanes is not 0
    return q, k, v, mask, tlen, dict(visual_len=5 * BN - 40,
                                     text_start=5 * BN)


@pytest.mark.parametrize("mode", ["int8", "mxu8"])
@pytest.mark.parametrize("chunk_blocks", [2, 16])
def test_k1q_plain_matches_jax(mode, chunk_blocks):
    """K1q's plain version against the Pallas kernel in interpret mode on
    the same int8 payload; at chunk_blocks 2 the lists span several chunks
    and the last one is padded, at 16 one padded chunk holds them.  Both
    modes hold fp32 rtol 2e-4 / atol 2e-5 on every row, the degenerate
    ones included (no p8 rounding tie flipped on these inputs)."""
    q, k, v, mask, tlen, kw = k1q_case(31 + chunk_blocks)
    payload = ops.quantize_kv_blocks(torch.from_numpy(k), torch.from_numpy(v),
                                     BN)
    idx, cnt = ops.mask_to_indices(torch.from_numpy(mask))
    got = tk.block_sparse_flash_attention(
        *map(torch.from_numpy, (q, k, v)), idx, cnt, torch.from_numpy(tlen),
        chunk_blocks=chunk_blocks, kv_quant=payload, quant_mode=mode, **kw)
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    want = np.asarray(jk.block_sparse_flash_attention(
        *map(jnp.asarray, (q, k, v)), jidx, jcnt, jnp.asarray(tlen),
        chunk_blocks=chunk_blocks, interpret=True,
        kv_quant=tuple(jnp.asarray(t.numpy()) for t in payload),
        quant_mode=mode, **kw))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert np.abs(want[1, 0, BM:2 * BM]).max() > 1e-3   # degenerate, not 0
    np.testing.assert_array_equal(got.numpy()[0, 0, 2 * BM:], 0.0)


@pytest.mark.parametrize("mode", ["int8", "mxu8"])
@pytest.mark.parametrize("q_dtype", ["float32", "float16"])
def test_k1q_q_dtypes_match_jax(mode, q_dtype):
    """K1q with an fp32 or fp16 q (the JAX kernel takes any q: "int8"
    rounds q * sm_scale to bf16, "mxu8" quantizes q's own values per row)
    against the Pallas kernel in interpret mode on the same payload, the
    output in q's type in both: all but at most 16 of the 49,152 elements
    (99.97 %) within fp32 rtol 2e-4 / atol 2e-5, and every element within
    rtol 2e-3 / atol 5e-4.  The two sum the scores in another order, so a
    p that lies within ~1e-7 of a rounding boundary of its bf16 ("int8")
    or int8 ("mxu8") value, or an output of an fp16 one, rounds the other
    way in one of them (on these inputs 0-13 elements, by at most 1.2e-4,
    0.16 of the wider bound)."""
    q, k, v, mask, tlen, kw = k1q_case(57)
    q = q.astype(q_dtype)
    payload = ops.quantize_kv_blocks(torch.from_numpy(k), torch.from_numpy(v),
                                     BN)
    idx, cnt = ops.mask_to_indices(torch.from_numpy(mask))
    got = tk.block_sparse_flash_attention(
        *map(torch.from_numpy, (q, k, v)), idx, cnt, torch.from_numpy(tlen),
        chunk_blocks=2, kv_quant=payload, quant_mode=mode, **kw)
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    want = jk.block_sparse_flash_attention(
        *map(jnp.asarray, (q, k, v)), jidx, jcnt, jnp.asarray(tlen),
        chunk_blocks=2, interpret=True,
        kv_quant=tuple(jnp.asarray(t.numpy()) for t in payload),
        quant_mode=mode, **kw)
    assert str(got.dtype) == f"torch.{q_dtype}" and want.dtype == q_dtype
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert (~np.isclose(got, want, **F32)).sum() <= 16
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4)
    np.testing.assert_array_equal(got[0, 0, 2 * BM:], 0.0)


@pytest.mark.parametrize("mode", ["int8", "mxu8"])
def test_site_kv_quant_matches_jax(mode):
    """rectified_sparse_attention with SparseConfig(kv_quant=...): joint
    layout, a visual length off the block grid, B=2 runtime text lengths;
    the visual rows run K1q, the text rows bf16 K1."""
    b, h, d, nq = 2, 1, 64, 3
    vis = nq * BM - 50
    kw = dict(top_k_floor=1, p_remain=0.3, layout="joint", text_len=BM,
              kv_quant=mode)
    q, k, v = (arr(40 + i, b, h, vis + BM, d) for i in range(3))
    nbr = np.random.default_rng(43).uniform(size=(nq, nq)) < 0.3
    tlen = np.array([100, 37], np.int32)
    want = np.asarray(j_rsa(
        *map(jnp.asarray, (q, k, v)), JConfig(**kw), jnp.asarray(nbr),
        visual_len=vis, text_len_rt=jnp.asarray(tlen), interpret=True))
    got = rectified_sparse_attention(
        *map(torch.from_numpy, (q, k, v)), SparseConfig(**kw),
        torch.from_numpy(nbr), visual_len=vis,
        text_len_rt=torch.from_numpy(tlen)).numpy()
    np.testing.assert_allclose(got, want, **SITE)
    with pytest.raises(ValueError, match="grouped"):
        SparseConfig(**{**kw, "group_rows": 2})


def qdense_params(seed, din, dout):
    mod = jq.QDense(dout)
    x = arr(seed, 2, 5, din)
    params = jax.tree_util.tree_map(np.asarray, mod.init(
        jax.random.PRNGKey(seed), jnp.asarray(x)))
    return mod, params, x


@pytest.mark.parametrize("bits", [8, 4])
def test_qlinear_matches_qdense(bits):
    """quantize_model and quantize_state_dict against quantize_params
    (min_size 1, as tests/test_quant.py): int8 values and int4 nibbles
    exact, scales exact; QLinear's output against QDense's at 1e-3 / 1e-4;
    dequantize_kernel against the JAX one; a skipped layer stays dense."""
    mod, params, x = qdense_params(3, 256, 96)
    jp = jq.quantize_params(params, bits=bits, min_size=1)
    node = jp["params"]
    lin = quant.QLinear(256, 96)
    load_flax_params(lin, params)
    sd = quant.quantize_state_dict(lin.state_dict(), bits=bits, min_size=1)
    quant.quantize_model(lin, bits=bits, min_size=1)
    assert lin.layout == {8: "int8", 4: "int4"}[bits]
    qname = "weight_q" if bits == 8 else "weight_q4"
    jname = "kernel_q" if bits == 8 else "kernel_q4"
    np.testing.assert_array_equal(getattr(lin, qname).numpy(),
                                  node[jname].T)
    np.testing.assert_array_equal(lin.scale.numpy(), node["kernel_scale"])
    for key, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), lin.state_dict()[key].numpy())
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(mod.apply(jp, x)), **TOL)
    np.testing.assert_allclose(quant.dequantize_kernel(lin).numpy(),
                               jq.dequantize_kernel(node).T, rtol=0, atol=0)
    # a bf16 model keeps its quantized buffers int / fp32
    lin = lin.to(torch.bfloat16)
    assert getattr(lin, qname).dtype in (torch.int8, torch.uint8)
    assert lin.scale.dtype == torch.float32
    dense = quant.QLinear(256, 96)
    quant.quantize_model(dense, bits=bits, min_size=1, skip=("",))
    assert dense.layout == "dense"
    small = quant.QLinear(256, 96)
    quant.quantize_model(small, bits=bits)            # 24,576 < 1 << 20
    assert small.layout == "dense"


def hunyuan_tiny():
    cfg = JHConfig.tiny()
    g = np.random.default_rng(0)
    text = g.normal(size=(1, 128, cfg.text_dim)).astype(np.float32)
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    jmod = JHDiT(cfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.in_channels, 2, 8, 8)),
        jnp.array([0.0]), jnp.asarray(text), jnp.asarray(mask),
        jnp.array([6000.0]), None, None))
    return jmod, params, text, mask


@pytest.mark.parametrize("bits", [8, 4])
def test_convert_quantized_tree(bits):
    """A tree from quantize_params bridges strictly into the port's model
    and equals the port's own quantize_model of the dense model; bytes as
    quantized_nbytes counts them in JAX."""
    _, params, _, _ = hunyuan_tiny()
    # group 32: the tiny widths (144, 320) are no multiples of 128
    jp = jq.quantize_params(params, bits=bits, group_size=32, min_size=1)
    model = load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()), jp)
    ref = quant.quantize_model(load_flax_params(
        HunyuanVideoDiT(HunyuanVideoConfig.tiny()), params), bits=bits,
        group_size=32, min_size=1)
    sd, want = model.state_dict(), ref.state_dict()
    assert sd.keys() == want.keys()
    assert any(k.endswith(".weight_q" if bits == 8 else ".weight_q4")
               for k in sd)
    for key in sd:
        torch.testing.assert_close(sd[key], want[key], rtol=0, atol=0)
    assert quant.quantized_nbytes(model) == jq.quantized_nbytes(jp)
    assert quant.quantized_nbytes(sd) == quant.quantized_nbytes(model)


def test_int8_residual_encode_and_offload_match_jax():
    """residual_value(..., "int8") bit for bit, the dequantizing add within
    fp32 rounding, and a TeaCache with the residual offloaded applies what
    it recorded."""
    x_in, x_out = arr(50, 2, 33, 64), arr(51, 2, 33, 64) * 0.1
    x_out[1, 4] = x_in[1, 4]                  # a zero row: scale 0
    q, scale = teacache.residual_value(torch.from_numpy(x_out),
                                       torch.from_numpy(x_in), "int8")
    jqv, jscale = jtc.residual_value(jnp.asarray(x_out), jnp.asarray(x_in),
                                     "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    hidden = arr(52, 2, 33, 64)
    np.testing.assert_allclose(
        teacache._dequant_add(torch.from_numpy(hidden), q, scale).numpy(),
        np.asarray(jtc._dequant_add(jnp.asarray(hidden), jqv, jscale)),
        rtol=1e-6, atol=1e-7)
    for store in ("bf16", "int8"):
        tea = TeaCache(0.1, 4, offload_residual=True)
        tea.should_compute(torch.from_numpy(hidden))
        res = teacache.residual_value(torch.from_numpy(x_out),
                                      torch.from_numpy(x_in), store)
        tea.record_residual_value(res)
        held = tea.states[0].previous_residual
        assert (isinstance(held, tuple)) == (store == "int8")
        got = tea.apply_residual(torch.from_numpy(hidden))
        want = (teacache._dequant_add(torch.from_numpy(hidden), *res)
                if store == "int8" else torch.from_numpy(hidden) + res)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def assert_close_but_residual_ties(got, want, tea):
    """Latents within 1e-3 / 1e-4, except where the int8 residual encode
    rounded a tie the other way: the two packages' residuals differ in fp32
    rounding, so an element near a .5 of the int8 grid can land one step
    apart, which moves the latents it reaches by a fraction of one quantum
    (the largest row scale).  On these inputs that is at most 3 of 1,024
    latents, 3.8e-4 from JAX; the test allows 1 % of them within one
    quantum."""
    err = np.abs(got - want)
    off = err > TOL["atol"] + TOL["rtol"] * np.abs(want)
    quantum = max(float(s.previous_residual[1].max()) for s in tea.states)
    assert off.mean() <= 0.01, off.mean()
    assert err.max() <= quantum, (err.max(), quantum)


@pytest.mark.parametrize("bits", [8, 4])
def test_tiny_hunyuan_pipeline_quantized_matches_jax(bits, tmp_path):
    """3 steps with TeaCache (the middle call skips) on quantized weights
    with the int8, host-offloaded residual: decisions identical call for
    call, latents within 1e-3 / 1e-4 but for residual rounding ties."""
    jmod, params, text, mask = hunyuan_tiny()
    jp = jq.quantize_params(params, bits=bits, group_size=32, min_size=1)
    tmod = load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()), jp)
    kw = dict(height=64, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="sparse", enable_teacache=True,
              rel_l1_thresh=0.8, text_len=128, group_rows=2,
              teacache_residual="int8", teacache_offload=True)
    jpipe = JHPipe(model=jmod, params=jp, interpret=True, **kw)
    init = np.random.default_rng(4).normal(
        size=(1, 4, *jpipe.grid)).astype(np.float32)
    trace = tmp_path / "trace.json"
    with jtc.trace_to(str(trace)):
        want = np.asarray(jpipe(jnp.asarray(text), jnp.asarray(mask),
                                init_latents=jnp.asarray(init)))
    jdec = [r["compute"] for r in json.loads(trace.read_text())
            if "call" in r]
    pipe = HunyuanVideoPipeline(model=tmod, device="cpu", **kw)
    got = pipe(text, mask, init_latents=init).numpy()
    assert pipe.teacache.decisions == jdec and False in jdec
    assert isinstance(pipe.teacache.states[0].previous_residual, tuple)
    assert_close_but_residual_ties(got, want, pipe.teacache)


def test_tiny_wan_pipeline_quantized_matches_jax(tmp_path):
    """3 CFG steps of the sparse Wan pipeline on int8 weights with the
    int8, host-offloaded residual: decisions identical, latents within
    1e-3 / 1e-4 but for residual rounding ties."""
    jcfg = JWConfig.tiny()
    jmod = JWDiT(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), np.zeros((1, jcfg.in_channels, 2, 8, 8),
                                        np.float32),
        np.zeros((1,), np.float32), arr(7, 1, 5, jcfg.text_dim), None))
    jp = jq.quantize_params(params, bits=8, min_size=1)
    tmod = load_flax_params(WanDiT(WanConfig.tiny()), jp)
    kw = dict(height=192, width=240, frames=5, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="sparse", enable_teacache=True,
              teacache_thresh=0.3, warm_layers=1, warm_calls=0,
              teacache_residual="int8", teacache_offload=True)
    jpipe = JWPipe(model=jmod, params=jp, interpret=True, **kw)
    pipe = WanPipeline(model=tmod, device="cpu", **kw)
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
    assert pipe.teacache.decisions == jdec and False in jdec
    assert_close_but_residual_ties(got, want, pipe.teacache)


@pytest.mark.parametrize("model", ["hunyuan", "wan21-t2v", "wan21-i2v"])
def test_cli_int8_levers_on_cpu(model, tmp_path, monkeypatch):
    """--quant (hunyuan int4, Wan int8), --teacache_residual int8 and
    --teacache_offload run through the CLI; at these widths no weight
    reaches quantize_params' 1 << 20 elements, so the run lowers min_size
    to show the quantized layers in use."""
    monkeypatch.setattr(quant, "quantize_model", functools.partial(
        quant.quantize_model, min_size=1))
    argv = ["--model", model, "--device", "cpu", "--scale", "0.05",
            "--height", "64", "--width", "64",
            "--frame", "8" if model == "hunyuan" else "5", "--num_steps", "2",
            "--enable_teacache", "--quant", "4" if model == "hunyuan"
            else "8", "--teacache_residual", "int8", "--teacache_offload",
            "--out_dir", str(tmp_path)]
    args = generate.parse_args(argv)
    args.sa_drop_rate, args.teacache_thresh = generate.DEFAULTS[model]
    pipe = (generate.build_hunyuan(args)[0] if model == "hunyuan"
            else generate.build_wan(args)[0])
    layouts = {m.layout for m in pipe.model.modules()
               if isinstance(m, quant.QLinear)}
    # layers with an odd input width (Wan's FFN at this scale) stay dense
    assert layouts - {"dense"} == {"int4" if model == "hunyuan" else "int8"}
    assert pipe.teacache_residual == "int8" and pipe.teacache_offload
    res = generate.main(argv)
    out = np.load(res["output"])
    assert np.isfinite(out).all() and out.shape[:2] == (1, 16)


def _s1_module():
    """scripts/bench_int8mxu.py, loaded from its file (it is a script)."""
    path = os.path.join(ROOT, "scripts", "bench_int8mxu.py")
    spec = importlib.util.spec_from_file_location("bench_int8mxu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_int8_probe_plain_matches_pallas(kind):
    """S1's plain version against the JAX script's _loop_kernel through
    pl.pallas_call in interpret mode, one pair at the script's shapes:
    int8 bit for bit, bf16 within fp32 rounding of the dot's order."""
    from jax.experimental import pallas as pl
    s1 = _s1_module()
    assert (s1.M, s1.D, s1.N, s1.REPS) == (int8_probe.M, int8_probe.D,
                                           int8_probe.N, int8_probe.REPS)
    gen = torch.Generator().manual_seed(9)
    a, b = int8_probe.random_pairs(kind, 1, gen)
    got = int8_probe.loop_dots(a, b)[0].numpy()
    if kind == "int8":
        ja, jb, odt = jnp.asarray(a[0].numpy()), jnp.asarray(b[0].numpy()), \
            jnp.int32
    else:
        ja, jb = (jnp.asarray(t[0].float().numpy(), jnp.bfloat16)
                  for t in (a, b))
        odt = jnp.float32
    want = np.asarray(pl.pallas_call(
        functools.partial(s1._loop_kernel, out_dtype=odt),
        out_shape=jax.ShapeDtypeStruct((s1.M, 128), jnp.float32),
        interpret=True)(ja, jb))
    if kind == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
