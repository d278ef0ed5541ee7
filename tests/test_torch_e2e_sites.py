"""The port's fidelity gate, long-context bench and dense-vs-sparse A/B
(rectified_spaattn_tpu_torch/bench: fidelity_gate, longctx, ab_eval)
against the JAX package:

- the fidelity and long-context sites on a tiny grid: the config,
  neighbours and the plan's counts bit for bit, the metrics at fp32
  2e-4 / 2e-5 against fidelity_gate.py's formula on JAX's outputs;
- ab_eval against JAX's pipelines on the same weights and seeds (the JAX
  script cannot run: its namespace lacks the CLI's mlp_chunk).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_e2e_common import F32, TOL, noise
from rectified_spaattn_tpu_torch import models as pm
from rectified_spaattn_tpu_torch.bench import e2e_weights as ew

torch.set_num_threads(1)


# -------------------------------------------------- fidelity, longctx ---

GRID = (4, 8, 16)           # 512 visual tokens in 4 blocks


def _jax_site(layout, text_len, **cfg_kw):
    """fidelity_gate.py's and bench_longctx.py's config and neighbours."""
    from rectified_spaattn_tpu.curves import cached_curve
    from rectified_spaattn_tpu.sparse import SparseConfig, select_block_num
    lt, lh, lw = GRID
    _, _, nbr = cached_curve(lt, lh, lw, block_size=128)
    img_blocks = lt * lh * lw // 128
    return SparseConfig(
        top_k_floor=max(1, select_block_num(0.8, img_blocks)), p_remain=0.3,
        layout=layout, text_len=text_len,
        first_frame_blocks=img_blocks // lt if layout == "visual" else 0,
        **cfg_kw), jnp.asarray(nbr)


def _jax_metrics(sp, dn, sv):
    """fidelity_gate.py:84-100 on JAX arrays."""
    sp = sp.astype(jnp.float32)[:, :, :sv]
    dn = dn.astype(jnp.float32)[:, :, :sv]
    diff = sp - dn
    mse = jnp.mean(diff * diff)
    rng = jnp.max(dn) - jnp.min(dn)
    return {"rel_l1": float(jnp.mean(jnp.abs(diff)) / jnp.mean(jnp.abs(dn))),
            "psnr_db": float(10.0 * jnp.log10(rng * rng
                                              / jnp.maximum(mse, 1e-30))),
            "cosine": float(jnp.sum(sp * dn) / jnp.maximum(
                jnp.linalg.norm(sp.ravel()) * jnp.linalg.norm(dn.ravel()),
                1e-30)),
            "rmse": float(jnp.sqrt(mse))}


@pytest.mark.parametrize("layout", ["joint", "visual"])
def test_fidelity_gate_matches_jax(layout):
    """The gate's config, neighbours and plan counts bit for bit in both
    layouts; in the joint layout its metrics on fp32 inputs at fp32 2e-4 /
    2e-5 against the script's formula on JAX's rectified_sparse_attention
    / _windowed_dense_flash (one JAX kernel compile a layout is the cost
    of this file; the visual layout's outputs run through the same
    functions)."""
    from rectified_spaattn_tpu.attention import rectified_sparse_attention
    from rectified_spaattn_tpu.attention.modes import _windowed_dense_flash
    from rectified_spaattn_tpu.sparse.pipeline import build_sparse_plan
    from rectified_spaattn_tpu_torch.bench import fidelity_gate as fg
    text_len = 256 if layout == "joint" else 0
    sv = GRID[0] * GRID[1] * GRID[2]
    s = sv + text_len
    cfg, nbr, _ = fg.point_site(GRID, drop=0.8, p_remain=0.3, layout=layout,
                                text_len=text_len, device="cpu")
    jcfg, jnbr = _jax_site(layout, text_len)
    assert vars(cfg) == vars(jcfg)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    g = np.random.default_rng(1)
    q, k, v = (g.normal(size=(1, 2, s, 128)).astype(np.float32)
               for _ in range(3))
    q[:, :, :sv] += 2.0 * g.normal(size=(1, 2, 1, 128)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    counts, density = fg.plan_density(tq, tk, tv, cfg, nbr, sv, s // 128)
    jcounts = build_sparse_plan(jnp.asarray(q[:, :, :sv]), jnp.asarray(k),
                                jnp.asarray(v), jcfg,
                                neighbor_mask=jnbr).counts
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert density == float(jnp.mean(jcounts)) / (s // 128)
    if layout == "visual":
        return
    sp, dn = fg.gate_outputs(tq, tk, tv, cfg, nbr, visual_len=sv,
                             text_len=text_len)
    tlen = jnp.full((1,), text_len, jnp.int32)
    jsp = rectified_sparse_attention(
        *map(jnp.asarray, (q, k, v)), jcfg, jnbr, visual_len=sv,
        text_len_rt=tlen if text_len else None, interpret=True)
    jdn = _windowed_dense_flash(
        *map(jnp.asarray, (q, k, v)), visual_len=sv,
        text_start=sv if text_len else None, tlen=tlen, interpret=True)
    got, want = fg.metrics(sp, dn, sv), _jax_metrics(jsp, jdn, sv)
    assert 0 < got["rel_l1"] and got["cosine"] < 1   # sparse != dense here
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **F32, err_msg=key)


@pytest.mark.parametrize("group_rows,packed", [(1, False), (2, False),
                                               (1, True)])
def test_longctx_point_matches_jax(group_rows, packed):
    """run_point on a tiny grid: its density from the plan's counts, bit
    for bit against bench_longctx.py's count function (packed: the plan
    reading the packed K|V) on the same inputs; the timed calls run."""
    from rectified_spaattn_tpu.sparse.pipeline import build_sparse_plan
    from rectified_spaattn_tpu_torch.bench import longctx
    from rectified_spaattn_tpu_torch.bench.inputs import smooth_qkv
    p = longctx.run_point(256, heads=2, grid=GRID, k_iters=1,
                          group_rows=group_rows, packed=packed,
                          device="cpu")
    assert p["tokens"] == 512 + 256 and p["sparse_ms"] > 0
    assert ("dense_ms" in p) == (not packed)
    # the inputs run_point made (seed 0), through JAX's count function
    _, _, h2l = longctx.point_site(GRID, drop=0.8, p_remain=0.3,
                                   layout="joint", text_len=256,
                                   device="cpu")
    q, k, v = (x.float().numpy() for x in smooth_qkv(
        torch.Generator().manual_seed(0), 2, 256, 128, h2l, GRID))
    jcfg, jnbr = _jax_site("joint", 256, group_rows=group_rows)
    if packed:
        counts = build_sparse_plan(
            jnp.asarray(q[:, :, :512]), None, None, jcfg, neighbor_mask=jnbr,
            kv_packed=jnp.concatenate([jnp.asarray(k), jnp.asarray(v)],
                                      -1)).counts
    else:
        counts = build_sparse_plan(jnp.asarray(q[:, :, :512]),
                                   jnp.asarray(k), jnp.asarray(v), jcfg,
                                   neighbor_mask=jnbr).counts
    assert p["density"] == float(jnp.mean(counts)) / (512 // 128 + 2)
    d = longctx.run_point(256, heads=2, grid=GRID, k_iters=1,
                          dense_only=True, packed=packed, device="cpu")
    assert d["dense_ms"] > 0 and "sparse_ms" not in d


# ------------------------------------------------------------- ab_eval ---

def test_ab_eval_matches_jax_pipelines():
    """ab_eval.run(small=True) against JAX's HunyuanVideoPipeline, dense
    then sparse, on the CLI's random weights (carried across), text and
    seed: the latents at 1e-3 / 1e-4, each metric against the script's
    formula on JAX's latents."""
    from rectified_spaattn_tpu.eval import evaluate_pair as jevaluate
    from rectified_spaattn_tpu.models import hunyuan as jh
    from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JPipe
    from rectified_spaattn_tpu_torch.bench import ab_eval
    from rectified_spaattn_tpu_torch.cli.generate import (_random_model,
                                                          _random_text)
    lat = {}
    got = ab_eval.run(small=True, device="cpu", latents_out=lat)
    s = ab_eval.SMALL
    # the CLI's random-weight config at --scale 0.05, and its weights
    cfg = pm.HunyuanVideoConfig(hidden_dim=128, heads=1, num_dual_blocks=1,
                                num_single_blocks=2, text_dim=512,
                                pooled_dim=128, num_refiner_blocks=1)
    model = _random_model(pm.HunyuanVideoDiT, cfg, torch.device("cpu"))
    params = {}
    for leaf in ew.flax_leaves(model):
        t = getattr(leaf.module, leaf.name).detach()
        node = params
        for seg in leaf.path[:-1]:
            node = node.setdefault(seg, {})
        x = t.t() if leaf.transposed else t
        node[leaf.path[-1]] = x.contiguous().numpy()
    jm = jh.HunyuanVideoDiT(jh.HunyuanVideoConfig(**vars(cfg)))
    text, mask = (x.numpy() for x in _random_text(
        "several hot air balloons flying over a city.", 256, 512))
    want = {}
    for mode in ("flash", "sparse"):
        jp = JPipe(model=jm, params={"params": params}, height=s["height"],
                   width=s["width"], frames=s["frame"],
                   num_steps=s["num_steps"], sa_drop_rate=0.8,
                   p_remain_rates=0.3, mode=mode, interpret=True)
        init = noise((1, 16, *jp.grid), seed=42)
        want[mode] = np.asarray(jp(jnp.asarray(text), jnp.asarray(mask),
                                   init_latents=jnp.asarray(init)))
        np.testing.assert_allclose(lat[mode].numpy(), want[mode], **TOL)
    # scripts/ab_eval.py:67-83 on JAX's latents
    d_img = want["flash"][0].mean(axis=0)[..., None]
    s_img = want["sparse"][0].mean(axis=0)[..., None]
    lo, hi = d_img.min(), d_img.max()
    d01 = (d_img - lo) / (hi - lo + 1e-8)
    s01 = np.clip((s_img - lo) / (hi - lo + 1e-8), 0, 1)
    per = [jevaluate(s01[t], d01[t]) for t in range(d01.shape[0])]
    for key in per[0]:
        np.testing.assert_allclose(
            got[key], np.mean([m[key] for m in per]), rtol=1e-3, atol=1e-6,
            err_msg=key)
    assert got["speedup"] == got["dense_seconds"] / got["sparse_seconds"]
