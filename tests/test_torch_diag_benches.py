"""The port's diagnostic benches (rectified_spaattn_tpu_torch/bench:
grouped, groupfull, coalesce, dense, kernel, fullpath, ab_randreg)
against the JAX package on the CPU at a tiny grid:

- each bench's own calls of the site / kernels, recorded where the bench
  looks them up while its ``main([... "--device", "cpu", "--small"])``
  runs, against JAX's ``rectified_sparse_attention``,
  ``block_sparse_flash_attention``, ``_windowed_dense_flash(block_m=)``
  and ``dense_attention`` on the same (bf16) inputs, the kernels in
  interpret mode as the JAX tests run them: bf16 2e-2;
- grouped's mask statistics and ab_randreg's density against the
  scripts' lines on JAX's plans of the same inputs, exactly; kernel's
  synthetic mask against bench_kernel.py's lines and its index lists
  against JAX's mask_to_indices, bit for bit;
- every bench refuses to run without a card unless asked for the CPU.
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_spaattn_tpu_torch.bench import (ab_randreg, coalesce, dense,
                                               fullpath, groupfull, grouped,
                                               kernel)
from rectified_spaattn_tpu_torch.sparse import SparseConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = dict(rtol=2e-2, atol=2e-2)
GRID = (4, 8, 16)           # 512 visual tokens in 4 blocks
SMALL = ["--device", "cpu", "--small", "--grid", "4,8,16"]


def to_jax(x):
    from rectified_spaattn_tpu.sparse import SparseConfig as JConfig
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())
    if isinstance(x, SparseConfig):
        return JConfig(**dataclasses.asdict(x))
    return x


def recorded(monkeypatch, mod, name) -> list:
    """Every call of ``mod.name`` from here on, as (args, kwargs, out)."""
    calls, orig = [], getattr(mod, name)

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(mod, name, rec)
    return calls


def held_to_jax(calls, jax_fn, interpret=True, **extra) -> int:
    """Each distinct recorded call (the timing loops repeat them) against
    ``jax_fn`` on the same arguments at bf16 2e-2; returns how many."""
    seen = set()
    for a, kw, out in calls:
        key = tuple(t.data_ptr() if torch.is_tensor(t) else repr(t)
                    for t in (*a, *kw.values()))
        if key in seen:
            continue
        seen.add(key)
        if interpret:
            extra["interpret"] = True
        want = jax_fn(*map(to_jax, a),
                      **{k: to_jax(x) for k, x in kw.items()}, **extra)
        got = out.float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)
    return len(seen)


def jax_rectified():
    from rectified_spaattn_tpu.attention import rectified_sparse_attention
    return rectified_sparse_attention


def jax_plan(q, k, v, cfg, sv, text_valid=None):
    from rectified_spaattn_tpu.curves import cached_curve
    from rectified_spaattn_tpu.sparse.pipeline import build_sparse_plan
    _, _, nbr = cached_curve(*GRID, block_size=128)
    return build_sparse_plan(
        to_jax(q)[:, :, :sv], to_jax(k), to_jax(v), to_jax(cfg),
        neighbor_mask=jnp.asarray(nbr),
        text_valid=None if text_valid is None else jnp.asarray(text_valid))


@pytest.mark.parametrize("name", ["planstages", "planopts", "grouped",
                                  "groupfull", "runstats", "coalesce",
                                  "dense", "kernel", "fullpath",
                                  "ab_randreg"])
def test_benches_default_to_the_card(name):
    mod = importlib.import_module(f"rectified_spaattn_tpu_torch.bench.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_grouped_matches_jax(monkeypatch):
    """G = 1 with K1q (int8) and G = 2 (K2) through the site, each
    against JAX's; the mask statistics against bench_grouped.py's lines
    (:135-150) on JAX's plan of the same inputs."""
    from rectified_spaattn_tpu_torch.pipelines import build_site
    calls = recorded(monkeypatch, grouped, "rectified_sparse_attention")
    line = grouped.main(SMALL + ["--groups", "1,2", "--iters", "1",
                                 "--kv_quant", "int8"])
    assert held_to_jax(calls, jax_rectified()) == 2
    assert [c[0][3].group_rows for c in calls][:1] == [1]
    assert calls[0][0][3].kv_quant == "int8"
    assert set(line["err_vs_g1"]) == {"g2"} and line["reference"] == "g1"
    site, _, h2l = build_site(*GRID, sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=256, device="cpu")
    pt = dict(grid=GRID, heads=4, head_dim=128, text_len=256)
    q, k, v = grouped.inputs(pt, h2l, shared_field=False, device="cpu")
    mask = np.asarray(jax_plan(q, k, v, site.cfg, 512,
                               np.ones((1, 256), bool)).block_mask)
    counts = mask.sum(-1)
    mg = mask.reshape(1, 4, 2, 2, -1)
    want = {"density": float(counts.mean()) / mask.shape[-1],
            "mean_count": float(counts.mean()),
            "union_growth_g2": float(mg.any(-2).sum(-1).mean()
                                     / (mg.sum((-1, -2)).mean() / 2))}
    assert {n: line["stats"][n] for n in want} == want
    # --shared_field: q and k of one smooth field (exp_runstats' draw), v = k
    q2, k2, v2 = grouped.inputs(pt, h2l, shared_field=True, device="cpu")
    assert v2 is k2 and q2.shape == k2.shape == (1, 4, 768, 128)


def test_groupfull_matches_jax(monkeypatch):
    calls = recorded(monkeypatch, groupfull, "rectified_sparse_attention")
    line = groupfull.main(SMALL + ["--iters", "1"])
    assert held_to_jax(calls, jax_rectified()) == 2
    assert line["g1_ch0"] > 0 and line["g2_ch0"] > 0
    assert line["g2_ch0_err"] == line["g2_ch0_rel"]["max_abs_err"] <= 2e-2


def test_coalesce_matches_jax(monkeypatch):
    """The site, K1 alone on the plan's lists, the windowed dense."""
    from rectified_spaattn_tpu.attention.modes import _windowed_dense_flash
    from rectified_spaattn_tpu.kernels import block_sparse_flash_attention
    site = recorded(monkeypatch, coalesce, "rectified_sparse_attention")
    k1 = recorded(monkeypatch, coalesce, "block_sparse_flash_attention")
    wd = recorded(monkeypatch, coalesce, "_windowed_dense_flash")
    line = coalesce.main(SMALL + ["--reps", "1"])
    assert held_to_jax(site, jax_rectified()) == 2       # two regimes
    assert held_to_jax(k1, block_sparse_flash_attention) == 2
    assert held_to_jax(wd, _windowed_dense_flash) == 1
    for regime in ("peaked", "random"):
        assert 0 < line[regime]["density"] <= 1


def test_dense_matches_jax(monkeypatch):
    """K3 and the windowed dense at block_m 256 / 512 / 1024 on one
    q = k = v draw."""
    from rectified_spaattn_tpu.attention.modes import _windowed_dense_flash
    from rectified_spaattn_tpu.kernels import dense_attention
    k3 = recorded(monkeypatch, dense, "dense_attention")
    wd = recorded(monkeypatch, dense, "_windowed_dense_flash")
    line = dense.main(["--device", "cpu", "--small", "--tokens", "512",
                       "--iters", "1"])
    assert held_to_jax(k3, dense_attention, interpret=False) == 1
    assert held_to_jax(wd, _windowed_dense_flash) == 3
    assert [c[1]["block_m"] for c in wd[::2]] == [256, 512, 1024]
    for key in ("stock_flash_k3", "windowed_bm256", "windowed_bm512",
                "windowed_bm1024", "sdpa_yardstick"):
        assert line[key]["ms"] > 0 and line[key]["tflops"] > 0
    assert line["flops"] == 4 * 4 * 512 * 512 * 128


def test_dense_reports_a_refused_block_m(monkeypatch):
    """A row height the kernel refuses is reported as failed by name."""
    def refuse(*a, block_m, **kw):
        if block_m == 512:
            raise ValueError("block_m 512 refused")
        return a[0]
    monkeypatch.setattr(dense, "_windowed_dense_flash", refuse)
    line = dense.run(tokens=256, heads=1, iters=1, device="cpu")
    assert line["windowed_bm512"]["failed"] == "ValueError"
    assert line["windowed_bm256"]["ms"] > 0


def test_kernel_matches_jax(monkeypatch):
    """The synthetic mask bit for bit against bench_kernel.py:60-66, its
    lists against JAX's mask_to_indices, K1 and K3 against JAX's."""
    from rectified_spaattn_tpu.kernels import (block_sparse_flash_attention,
                                               dense_attention)
    from rectified_spaattn_tpu.sparse.ops import mask_to_indices
    g = np.random.default_rng(0)
    want = np.zeros((1, 2, 12, 14), bool)
    for off in (-1, 0, 1):
        idx = np.arange(12)
        want[:, :, idx, np.clip(idx + off, 0, 11)] = True
    want[:, :, :, :12] |= g.uniform(size=(1, 2, 12, 12)) < 0.25
    want[:, :, :, 12:] = True
    mask = kernel.synthetic_mask(1, 2, 12, 14, 0.25)
    np.testing.assert_array_equal(mask, want)
    k1 = recorded(monkeypatch, kernel, "block_sparse_flash_attention")
    k3 = recorded(monkeypatch, kernel, "dense_attention")
    line = kernel.main(["--device", "cpu", "--small", "--iters", "1"])
    idx, counts = k1[0][0][3:5]
    jidx, jcounts = mask_to_indices(jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert k1[0][1]["chunk_blocks"] == 8
    assert held_to_jax(k1, block_sparse_flash_attention) == 1
    assert held_to_jax(k3, dense_attention, interpret=False) == 1
    assert line["mask_density"] == float(mask.mean())
    assert line["ideal_speedup"] == 1 / line["mask_density"]
    skip = kernel.main(["--device", "cpu", "--small", "--iters", "1",
                        "--skip-dense"])
    assert skip["dense_ms"] is None and skip["speedup_vs_dense"] is None


def test_fullpath_matches_jax(monkeypatch):
    calls = recorded(monkeypatch, fullpath, "rectified_sparse_attention")
    line = fullpath.main(SMALL + ["--iters", "1"])
    assert held_to_jax(calls, jax_rectified()) == 1
    q, k, v = calls[0][0][:3]
    assert q is k is v                    # one draw, as the script's
    assert line["tokens"] == 768 and 0 < line["mask_density"] <= 1


def test_ab_randreg_runs_a_tree_in_its_own_process():
    """--root runs the measurement in a child process importing that
    tree's package; its density equals the script's on JAX's plan of the
    same inputs (iid normal, seed 1)."""
    from rectified_spaattn_tpu_torch.bench.inputs import random_inputs
    from rectified_spaattn_tpu_torch.pipelines import build_site
    line = ab_randreg.main(SMALL + ["--root", ROOT])
    assert line["repo"] == ROOT and line["device"] == "cpu"
    site, _, _ = build_site(*GRID, sa_drop_rate=0.8, p_remain=0.3,
                            layout="joint", text_len=256, device="cpu")
    q, k, v = random_inputs(torch.Generator().manual_seed(1), 4, 768, 128)
    plan = jax_plan(q, k, v, site.cfg, 512)
    want = float(jnp.mean(plan.counts)) / plan.indices.shape[-1]
    assert line["density"] == pytest.approx(want, rel=1e-6)
    assert line["oneshot_ms"] > 0 and line["plan_ms"] > 0
