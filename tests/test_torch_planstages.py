"""The port's plan-stage, plan-variant and run-statistics benches
(rectified_spaattn_tpu_torch/bench: planstages, planopts, runstats)
against the JAX side on the same numpy inputs:

- every stage of planstages against the same stage composed from JAX's
  sparse/ops.py (bench_planstages.py's lines, restated: the stages are
  local to its main), each on the port's own inputs to that stage:
  integers bit for bit, fp32 at 2e-4 / 2e-5; the staged mask, indices and
  counts against JAX's build_sparse_plan bit for bit; the site's pad and
  text validity against JAX's rectified site;
- planopts' variants A / B / C, its index sort and mask2idx's sort,
  scatter and int16 compactions against the scripts' lines (restated:
  both scripts run at import), bit for bit;
- runstats' dma_decomposition, stats and union_growth against
  exp_runstats.py's own functions, and its plans against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_e2e_common import F32, script
from rectified_spaattn_tpu_torch.bench import planopts, planstages, runstats

torch.set_num_threads(1)

GRID = (4, 8, 16)           # 512 visual tokens in 4 blocks


def jax_cfg(cfg):
    from rectified_spaattn_tpu.sparse import SparseConfig
    return SparseConfig(**dataclasses.asdict(cfg))


def np_(x):
    return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
        else x.detach().numpy()


def same(got, want, exact=False):
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


def fp32_site(grid=GRID, heads=2, tlen=None):
    """planstages.site_inputs on the CPU with its q / k / v in fp32."""
    st = planstages.site_inputs(grid, heads, 128, 256, tlen=tlen,
                                device="cpu")
    return {**st, **{n: st[n].float() for n in ("qv", "k", "v")}}


def jax_stages(cfg, nbr, qv, k, v, mids):
    """bench_planstages.py:118-166's stages on JAX arrays; each stage
    after the first reads the port's own input to it (``mids``)."""
    from rectified_spaattn_tpu.sparse import ops
    b, h, sv, d = qv.shape
    bm = bn = 128
    nq = sv // bm
    nmask = jnp.asarray(nbr)
    a = {n: jnp.asarray(np_(t)) for n, t in mids.items()
         if torch.is_tensor(t)}
    q_pool = ops.block_pool(qv, bm)
    k_pool_vis = ops.block_pool(k[:, :, :nq * bn], bn)
    key_text = k[:, :, nq * bn: nq * bn + cfg.text_len].astype(jnp.float32)
    k_cols = jnp.concatenate([a["k_pool_vis"], key_text], axis=-2)
    scores_unscaled = ops.pooled_scores(a["q_pool"], k_cols)
    probs_tok = jax.nn.softmax(scores_unscaled * (d ** -0.5), axis=-1)
    q_blocks = qv.reshape(b, h, nq, bm, d)
    k_blocks = k[:, :, :nq * bn].reshape(b, h, nq, bn, d)
    nogapr = ops.estimate_pr_gain(q_blocks, k_blocks, a["q_pool"],
                                  a["k_pool_vis"],
                                  a["scores_unscaled"][..., :nq])
    probs = ops.ipar_reallocate(a["probs_tok"], nq, bn)
    onehot = ops.topp_threshold_onehot_bisect(a["probs"], cfg.p_remain,
                                              cfg.top_k_floor)
    vis_cols = a["onehot"][..., :nq] | nmask[None, None, :nq, :nq]
    block_mask = jnp.concatenate(
        [vis_cols, jnp.ones((b, h, nq, cfg.text_blocks), bool)], axis=-1)
    partial = jnp.concatenate(
        [vis_cols | a["nogapr"], jnp.ones((b, h, nq, 1), bool)], axis=-1)
    value_pool = ops.block_pool(v, bn)[:, :, :nq + 1]
    r, comp = ops.rectification(a["probs"], partial, value_pool)
    return {"q_pool": q_pool, "k_pool_vis": k_pool_vis,
            "scores_unscaled": scores_unscaled, "probs_tok": probs_tok,
            "nogapr": nogapr, "probs": probs, "onehot": onehot,
            "block_mask": block_mask, "r_factor": r, "comp": comp,
            "mask_to_indices": ops.mask_to_indices(a["block_mask"])}


def test_plan_stages_match_jax():
    """Each stage of planstages against bench_planstages.py's stage on the
    same inputs, and the stages' mask / indices / counts against JAX's
    build_sparse_plan bit for bit."""
    from rectified_spaattn_tpu.sparse.pipeline import build_sparse_plan
    st = fp32_site()
    cfg, nbr = st["site"].cfg, st["site"].neighbor_mask
    mids, calls = planstages.stages(st)
    (q_pool, k_pool_vis) = calls["pool(q,k)"]()
    scores_unscaled, probs_tok = calls["scores+softmax"]()
    port = {"q_pool": q_pool, "k_pool_vis": k_pool_vis,
            "scores_unscaled": scores_unscaled, "probs_tok": probs_tok,
            "nogapr": calls["gapr"](), "probs": calls["ipar"](),
            "onehot": calls["bisect-topp"](),
            "block_mask": calls["mask-assembly"]()}
    port["r_factor"], port["comp"] = calls["rectification"]()
    port["mask_to_indices"] = calls["mask->indices"]()
    qv, k, v = (jnp.asarray(np_(st[n])) for n in ("qv", "k", "v"))
    want = jax_stages(cfg, nbr.numpy(), qv, k, v, port)
    for name, w in want.items():
        exact = name in ("nogapr", "onehot", "block_mask", "mask_to_indices")
        if name == "mask_to_indices":
            for g, x in zip(port[name], w):
                same(g, x, exact=True)
        else:
            same(port[name], w, exact=exact)
    plan = build_sparse_plan(qv, k, v, jax_cfg(cfg),
                             neighbor_mask=jnp.asarray(nbr.numpy()))
    for n in ("block_mask", "indices", "counts"):
        same(mids[n], getattr(plan, n), exact=True)
    i16, c16 = calls["mask->indices-int16"]()
    assert i16.dtype == torch.int32 and i16.shape == mids["indices"].shape
    assert bool((c16 >= mids["counts"]).all())   # p > 1e-9 keeps more


@pytest.mark.parametrize("grid,tlen", [(GRID, None), ((3, 8, 12), 100)])
def test_planstages_run_recomposes_the_plan(grid, tlen):
    """run() on the CPU: the stages recompose build_sparse_plan bit for
    bit, also where the visual region is padded to whole blocks with 100
    of 256 text tokens valid (the CogVideoX case); the padded site's
    density equals JAX's rectified site's on the same unpadded inputs."""
    from rectified_spaattn_tpu.attention import rectified_sparse_attention
    from rectified_spaattn_tpu.curves import cached_curve
    line = planstages.run(grid=grid, heads=2, tlen=tlen, k=1, reps=1,
                          device="cpu")
    assert all(line["staged_equals_plan"].values())
    assert line["int16_sort_equals_indices"]
    assert [r["stage"] for r in line["stages"]] == list(
        planstages.stages(fp32_site(grid, tlen=tlen))[1])
    assert line["stage_sum"]["kernel_ms"] is None   # no card: no trace
    if tlen is None:
        return
    # the same draw unpadded, through JAX's site (it pads and masks)
    st = planstages.site_inputs(grid, 2, 128, 256, tlen=tlen, device="cpu")
    sv = st["site"].visual_len
    gen = torch.Generator().manual_seed(0)
    from rectified_spaattn_tpu_torch.bench.inputs import smooth_qkv
    from rectified_spaattn_tpu_torch.pipelines import build_site
    _, _, h2l = build_site(*grid, sa_drop_rate=0.8, p_remain=0.3,
                           layout="joint", text_len=256, device="cpu")
    q, k, v = (jnp.asarray(x.float().numpy())
               for x in smooth_qkv(gen, 2, 256, 128, h2l, grid))
    _, _, nbr = cached_curve(*grid, block_size=128)
    nb_pad = -(-sv // 128)
    nbr = np.pad(nbr, ((0, nb_pad - nbr.shape[0]),) * 2)
    dens = rectified_sparse_attention(
        q, k, v, jax_cfg(st["site"].cfg), jnp.asarray(nbr), visual_len=sv,
        text_len_rt=jnp.full((1,), tlen, jnp.int32), density_only=True)
    assert line["mask_density"] == pytest.approx(float(dens), rel=1e-6)


# ----------------------------------------------------------- planopts ---

def jax_variants(probs, p_remain, floor):
    """bench_planopts.py:21-62, restated (the script runs at import)."""
    nk = probs.shape[-1]
    order = jnp.argsort(-probs, axis=-1)
    sp = jnp.take_along_axis(probs, order, axis=-1)
    counts = jnp.maximum(jnp.sum(jnp.cumsum(sp, axis=-1) <= p_remain,
                                 -1).astype(jnp.int32) + 1, floor)
    a = jnp.argsort(order, axis=-1) < counts[..., None]
    spb = jnp.sort(probs, axis=-1)[..., ::-1]
    cb = jnp.maximum(jnp.sum(jnp.cumsum(spb, axis=-1) <= p_remain,
                             -1).astype(jnp.int32) + 1, floor)
    thresh = jnp.take_along_axis(spb, (cb - 1)[..., None].astype(jnp.int32),
                                 axis=-1)
    iota = jnp.broadcast_to(jnp.arange(nk, dtype=jnp.int32), order.shape)
    rank = jnp.put_along_axis(jnp.zeros_like(order), order, iota, axis=-1,
                              inplace=False)
    col = jnp.arange(nk, dtype=jnp.int32)
    isort = jnp.sort(jnp.where(a, col, col + nk), axis=-1)
    return {"A": (a, counts), "B": (probs >= thresh, cb),
            "C": (rank < counts[..., None], counts), "index_sort": isort}


def jax_m2i(mask):
    """bench_mask2idx.py:25-50 and bench_planstages2.py:180-196."""
    nb = mask.shape[-1]
    col = jnp.arange(nb, dtype=jnp.int32)
    counts = jnp.sum(mask, axis=-1).astype(jnp.int32)
    slot = col[(None,) * 3]

    def pad_last(idx):
        last = jnp.take_along_axis(idx, jnp.maximum(counts - 1, 0)[..., None],
                                   axis=-1)
        return jnp.where(slot < counts[..., None], idx, last)

    srt = pad_last(jnp.sort(jnp.where(mask, col, col + nb), axis=-1))
    colb = jnp.broadcast_to(col, mask.shape)
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
    idx = jnp.put_along_axis(jnp.zeros(mask.shape, jnp.int32),
                             jnp.where(mask, rank, nb - 1), colb, axis=-1,
                             inplace=False)
    col16 = jnp.arange(nb, dtype=jnp.int16)
    i16 = jnp.sort(jnp.where(mask, col16, col16 + jnp.int16(nb)),
                   axis=-1).astype(jnp.int32)
    return {"sort": (srt, counts), "scatter": (pad_last(idx), counts),
            "int16": (jnp.minimum(pad_last(i16), nb - 1), counts)}


@pytest.mark.parametrize("peaked", [False, True])
def test_planopts_variants_match_the_scripts(peaked):
    """A / B / C and the index sort against bench_planopts.py's lines on
    the same probabilities, mask2idx's three compactions against theirs
    on bench_mask2idx.py's numpy mask: bit for bit."""
    g = np.random.default_rng(3 + peaked)
    logits = g.normal(size=(1, 3, 40, 41)).astype(np.float32) * (
        6.0 if peaked else 1.0)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    tp = torch.from_numpy(probs)
    want = jax_variants(jnp.asarray(probs), 0.3, 8)
    got = {"A": planopts.variant_a(tp, 0.3, 8),
           "B": planopts.variant_b(tp, 0.3, 8),
           "C": planopts.variant_c(tp, 0.3, 8)}
    for n in "ABC":
        for x, y in zip(got[n], want[n]):
            same(x, y, exact=True)
    same(planopts.index_sort(got["A"][0]), want["index_sort"], exact=True)
    assert torch.equal(got["A"][0], got["C"][0])
    mask = planopts.m2i_mask((1, 3, 20, 24))
    np.testing.assert_array_equal(
        mask, np.random.default_rng(0).uniform(size=(1, 3, 20, 24)) < 0.3)
    wm = jax_m2i(jnp.asarray(mask))
    tm = torch.from_numpy(mask)
    for n, f in (("sort", planopts.via_sort), ("scatter",
                                               planopts.via_scatter),
                 ("int16", planopts.via_int16)):
        for x, y in zip(f(tm), wm[n]):
            same(x, y, exact=True)


def test_planopts_main_small():
    line = planopts.main(["--device", "cpu", "--small", "--reps", "1",
                          "--k", "1"])
    t, m = line["topp"], line["mask2idx"]
    assert t["a_equals_c"] and t["counts_equal"] and t["a_c_counts_equal"]
    assert m["sort_equals_scatter"] and m["sort_equals_int16"]
    assert m["sort_equals_ops"] and line["device"] == "cpu"
    for key in ("A_two_argsorts", "B_sort_threshold",
                "C_argsort_scatter_rank", "index_compaction_sort"):
        assert t[key]["oneshot_ms"] > 0 and t[key]["event_ms"] > 0


# ----------------------------------------------------------- runstats ---

def test_runstats_functions_match_the_script(capsys):
    """dma_decomposition bit for bit, stats' numbers as the script prints
    them, union_growth exactly, on lists with runs, gaps and a chunk
    boundary."""
    ers = script("exp_runstats")
    g = np.random.default_rng(9)
    mask = g.uniform(size=(1, 2, 12, 40)) < 0.35
    mask[0, 0, 3, 5:29] = True                 # a long run over a boundary
    mask[0, 1, 7] = False
    from rectified_spaattn_tpu_torch.sparse.ops import mask_to_indices
    idx, cnt = (x.numpy() for x in mask_to_indices(torch.from_numpy(mask)))
    np.testing.assert_array_equal(runstats.dma_decomposition(idx, cnt),
                                  ers.dma_decomposition(idx, cnt))
    for chunk in (16, 8):
        np.testing.assert_array_equal(
            runstats.dma_decomposition(idx, cnt, chunk),
            ers.dma_decomposition(idx, cnt, chunk))
    got = runstats.stats(idx, cnt)
    ers.stats(type("P", (), {"indices": idx, "counts": cnt}), "x")
    assert capsys.readouterr().out == script_stats_text(got, "x")
    assert sum(got["run_size_share"].values()) == pytest.approx(1.0)
    single, growth = runstats.union_growth(mask)
    wsingle, wgrowth = ers.union_growth(mask)
    assert single == wsingle and growth == wgrowth


def script_stats_text(s: dict, label: str) -> str:
    """exp_runstats.py:96-100's two lines from stats()' numbers."""
    n_now, n_coal = s["descriptors"], s["descriptors_coalesced"]
    return (f"[{label}] density={s['density']:.3f} "
            f"mean_count={s['mean_count']:.0f} descriptors {n_now} -> "
            f"{n_coal} ({n_now / n_coal:.2f}x fewer)\n"
            "    run-size histogram: " + ", ".join(
                f"{k}:{v:.2%}" for k, v in s["run_size_share"].items())
            + "\n")


def test_runstats_run_matches_jax_plans(capsys):
    """run() on the CPU at a tiny grid: both regimes' statistics equal
    the script's stats of JAX's plan on the same inputs."""
    from rectified_spaattn_tpu.curves import cached_curve
    from rectified_spaattn_tpu.sparse.pipeline import build_sparse_plan
    from rectified_spaattn_tpu_torch.bench.inputs import (curve_coords,
                                                          smooth_inputs)
    from rectified_spaattn_tpu_torch.pipelines import build_site
    ers = script("exp_runstats")
    line = runstats.main(["--device", "cpu", "--heads", "2", "--lt", "4",
                          "--lh", "8", "--lw", "16"])
    capsys.readouterr()
    site, _, h2l = build_site(*GRID, sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=256, device="cpu")
    _, _, nbr = cached_curve(*GRID, block_size=128)
    for label, (a, s) in (("peaked", (4.0, 1.0)), ("random", (0.0, 1.0))):
        gen = torch.Generator().manual_seed(0)
        q, k = (jnp.asarray(x.float().numpy()) for x in smooth_inputs(
            gen, 2, curve_coords(h2l, GRID), 256, 128, n=2, alpha=a,
            sigma=s))
        plan = build_sparse_plan(q[:, :, :512], k, k, jax_cfg(site.cfg),
                                 neighbor_mask=jnp.asarray(nbr))
        ers.stats(plan, label)
        assert capsys.readouterr().out == script_stats_text(line[label],
                                                            label)
        assert sum(line[label]["run_size_share"].values()) == \
            pytest.approx(1.0)
        single, growth = ers.union_growth(plan.block_mask)
        assert line[label]["union_single"] == single
        # (G = 8 over 4 rows is empty: NaN on both sides)
        np.testing.assert_equal({g: (x["union"], x["growth"]) for g, x in
                                 line[label]["union_growth"].items()},
                                growth)
