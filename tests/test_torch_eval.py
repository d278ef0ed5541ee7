"""The port's batch evaluation against the JAX package on the CPU: the diff
metrics, the prompt utilities, the FID math and the gated adapters,
``_prompt_encoder``, ``run_eval.main`` against JAX's on one tiny snapshot
(the same noise and pseudo-text on both sides), ``run_eval.main`` through
every family's builder, the batch (dp) x head (tp) split of
``head_parallel_rectified_attention`` over four gloo ranks, and the
multi-process launcher over two.

Tolerances: the diff metrics and the FID math are float64 on both sides,
rtol 1e-10; the prompt utilities match exactly; run_eval's written frames
and full outputs at fp32 rtol 2e-4 / atol 2e-5 (tests/test_kernels.py:44)
and its diff_vs_dense metrics at rtol 1e-3; the dp x tp site at 2e-3, the
tolerance of the tp = 2 site (tests/test_torch_parallel.py); the launcher's
files equal the one-process run's byte for byte."""

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import (
    rectified_sparse_attention as j_rectified)
from rectified_spaattn_tpu.cli import generate as jgen
from rectified_spaattn_tpu.eval import diff_metrics as jdm
from rectified_spaattn_tpu.eval import generation as jgeneration
from rectified_spaattn_tpu.eval import quality as jquality
from rectified_spaattn_tpu.eval import run_eval as jrun_eval
from rectified_spaattn_tpu.models import pretrained as jpre
from rectified_spaattn_tpu.parallel import shard_prompts as j_shard_prompts
from rectified_spaattn_tpu.sparse import SparseConfig as JConfig
from rectified_spaattn_tpu_torch import eval as teval
from rectified_spaattn_tpu_torch.cli import generate as gen
from rectified_spaattn_tpu_torch.eval import diff_metrics as dm
from rectified_spaattn_tpu_torch.eval import generation
from rectified_spaattn_tpu_torch.eval import quality
from rectified_spaattn_tpu_torch.eval import run_eval
from rectified_spaattn_tpu_torch.models import pretrained as pre
from rectified_spaattn_tpu_torch.parallel import shard_prompts

import _torch_dist_workers as workers
import test_torch_io
from test_torch_parallel import join, spawn

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=1e-10, atol=0)
FP32 = dict(rtol=2e-4, atol=2e-5)
SITE = dict(rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------ diff metrics ---

def metric_inputs(case):
    g = np.random.default_rng(7)
    if case == "hwc_01":
        a = g.uniform(size=(12, 10, 3))
        return a, np.clip(a + 0.05 * g.standard_normal(a.shape), 0, 1)
    if case == "fhwc_pm1":
        a = g.uniform(-1, 1, (3, 9, 11, 3))
        return a, np.clip(a + 0.1 * g.standard_normal(a.shape), -1, 1)
    if case == "hw_latent":           # unbounded, [-1, 1] side of _to01
        a = g.standard_normal((8, 8))
        return a, a + 0.2 * g.standard_normal(a.shape)
    if case == "identical":
        a = g.uniform(-1, 1, (2, 8, 8, 4)).astype(np.float32)
        return a, a.copy()
    if case == "constant":
        return np.full((8, 12, 3), 0.25), g.uniform(size=(8, 12, 3))
    raise KeyError(case)


METRICS = ("rmse", "psnr", "relative_l1", "cosine_similarity", "ssim")
CASES = ("hwc_01", "fhwc_pm1", "hw_latent", "identical", "constant")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_diff_metric_matches_jax(metric, case):
    """Each metric against JAX's numpy function on the same arrays, given
    numpy arrays and float32 tensors alike (float64 inside)."""
    a, b = metric_inputs(case)
    want = getattr(jdm, metric)(a, b)
    for x, y in ((a, b), (torch.from_numpy(a), torch.from_numpy(b))):
        got = getattr(dm, metric)(x, y)
        assert isinstance(got, float)
        if np.isinf(want):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, **EXACT)
    if case == "identical":
        assert dm.psnr(a, b) == float("inf") and dm.rmse(a, b) == 0.0


def test_evaluate_pair_and_lpips_gate():
    a, b = metric_inputs("fhwc_pm1")
    got, want = dm.evaluate_pair(a, b), jdm.evaluate_pair(a, b)
    assert sorted(got) == sorted(want)            # no lpips here
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EXACT)
    assert dm.lpips(a[0], b[0]) is None


# ---------------------------------------------------- prompts and images ---

def test_prompt_loaders_match_jax(tmp_path):
    lines = [f"prompt {i}, with punctuation!" for i in range(50)]
    files = {
        "list.json": json.dumps(lines),
        "dicts.json": json.dumps([{"prompt": p, "image": f"{i}.png"}
                                  for i, p in enumerate(lines)]),
        "lines.txt": "\n".join(lines[:10] + ["", "  "] + lines[10:]) + "\n",
    }
    for name, text in files.items():
        path = str(tmp_path / name)
        with open(path, "w") as f:
            f.write(text)
        for kw in ({}, {"limit": 600}, {"limit": 10, "seed": 42},
                   {"limit": 7, "seed": 3}):
            got = generation.load_prompts(path, **kw)
            assert got == jgeneration.load_prompts(path, **kw), (name, kw)
        assert len(generation.load_prompts(path, limit=10)) == 10
    pairs = str(tmp_path / "pairs.json")
    with open(pairs, "w") as f:
        json.dump([{"prompt": "a", "image": "x.png"},
                   {"prompt": "b", "image_path": "y.png"},
                   {"prompt": "c"}], f)
    assert generation.load_prompt_image_pairs(pairs) == \
        jgeneration.load_prompt_image_pairs(pairs) == \
        [("a", "x.png"), ("b", "y.png"), ("c", "")]


@pytest.mark.parametrize("prompt", [
    "a dog!", "  spaces  and, commas; (parens) ", "ünïcödé – dash 猫 🐈",
    "x" * 200, "tabs\tand\nnewlines", "--dashes__under--"])
def test_safe_name_matches_jax(prompt):
    assert generation.safe_name(prompt) == jgeneration.safe_name(prompt)
    assert generation.safe_name(prompt, 9) == jgeneration.safe_name(prompt, 9)


@pytest.mark.parametrize("hw", [(90, 160), (100, 160), (90, 200), (33, 17),
                                (720, 1280), (1, 1)])
def test_center_crop_16_9_matches_jax(hw):
    img = np.arange(hw[0] * hw[1] * 3).reshape(*hw, 3)
    np.testing.assert_array_equal(generation.center_crop_16_9(img),
                                  jgeneration.center_crop_16_9(img))


def test_shard_prompts_and_generate_batch(tmp_path):
    prompts = [f"p{i}" for i in range(10)]
    for n in (1, 2, 3, 4):
        for i in range(n):
            assert shard_prompts(prompts, i, n) == j_shard_prompts(
                prompts, i, n)
    assert shard_prompts(prompts) == prompts          # no group: 0 of 1

    def fake(prompt, seed=0):
        g = np.random.default_rng(seed)
        return torch.from_numpy(g.uniform(size=(4, 8, 8, 3)))

    paths = generation.generate_batch(fake, ["a cat", "a dog!"],
                                      str(tmp_path / "a"), loops=2,
                                      shard_index=1, num_shards=2)
    assert [os.path.basename(p) for p in paths] == ["a_dog-0.npy",
                                                    "a_dog-1.npy"]
    want = jgeneration.generate_batch(
        lambda p, seed=0: fake(p, seed).numpy(), ["a cat", "a dog!"],
        str(tmp_path / "b"), loops=2, shard_index=1, num_shards=2)
    for p, q in zip(paths, want):
        np.testing.assert_array_equal(np.load(p), np.load(q))
    none = generation.generate_batch(fake, ["a cat"], str(tmp_path / "c"),
                                     write=False)
    assert none == [str(tmp_path / "c" / "a_cat-0.mp4")]
    assert not os.path.exists(tmp_path / "c")


# --------------------------------------------------- FID and the adapters ---

def test_frechet_distance_and_statistics_match_jax():
    g = np.random.default_rng(0)
    fa, fb = g.normal(size=(64, 5)), g.normal(1.0, 2.0, size=(40, 5))
    for feats in (fa, fb, g.normal(size=(3, 1))):
        for got, want in zip(quality.activation_statistics(feats),
                             jquality.activation_statistics(feats)):
            np.testing.assert_allclose(got, want, **EXACT)
    (ma, sa), (mb, sb) = map(quality.activation_statistics, (fa, fb))
    for args in ((ma, sa, mb, sb), (ma, sa, ma, sa),
                 (np.zeros(2), np.diag([1.0, 4.0]), np.array([3.0, 0.0]),
                  np.diag([9.0, 1.0]))):
        np.testing.assert_allclose(quality.frechet_distance(*args),
                                   jquality.frechet_distance(*args),
                                   rtol=1e-10, atol=1e-9)
    # a singular covariance: the eps-jitter retry path
    s = np.zeros((3, 3))
    np.testing.assert_allclose(quality.frechet_distance(ma[:3], s, mb[:3], s),
                               jquality.frechet_distance(ma[:3], s, mb[:3], s),
                               **EXACT)


def test_gated_adapters_report_unavailable(tmp_path):
    """None of vbench, ImageReward, torchvision or a VisionReward
    checkpoint is installed: each adapter returns available False, as
    JAX's does (the CLIP and PickScore adapters would look their weights
    up by hub name, and are reached only with real text encoders)."""
    assert quality.run_vbench(str(tmp_path))["available"] is False
    r = quality.run_visionreward(["nope.mp4"], ["prompt"], device="cpu")
    assert r["available"] is False and "unavailable" in r["reason"]
    assert quality.image_reward(["x.png"], ["p"])["available"] is False
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    assert quality.fid_score(str(tmp_path / "a"), str(tmp_path / "b")) == \
        jquality.fid_score(str(tmp_path / "a"), str(tmp_path / "b"))
    assert quality.VBENCH_DIMENSIONS == jquality.VBENCH_DIMENSIONS
    out = quality.write_scores({"x": 1}, str(tmp_path / "s" / "scores.json"))
    assert json.load(open(out)) == {"x": 1}
    assert set(teval.__all__) == set(__import__(
        "rectified_spaattn_tpu.eval", fromlist=["__all__"]).__all__)


def test_prompt_encoder_uses_real_encoders(monkeypatch):
    """With --ckpt_dir every family embeds through the snapshot's encoder
    and re-pools per prompt (JAX tests/test_eval.py:93-138); without one,
    the CLI's pseudo-embedding on args.device."""
    calls, pooled_calls = [], []

    class FakeEncoder:
        def __call__(self, prompt):
            calls.append(prompt)
            return torch.zeros((1, 4, 8)), torch.ones((1, 4), dtype=torch.bool)

    class FakePooled:
        def pooled(self, prompt):
            pooled_calls.append(prompt)
            return torch.zeros((1, 8))

    seen = []
    monkeypatch.setattr(pre, "load_text_encoders", lambda fam, root, **kw: (
        seen.append((fam, kw)), [FakeEncoder(), FakePooled()])[1])
    for model, fam in (("hunyuan", "hunyuan"), ("wan22-i2v", "wan"),
                       ("cogvideox-t2v", "cogvideox"),
                       ("flux-upscale", "flux")):
        args = argparse.Namespace(model=model, ckpt_dir="/fake",
                                  device="cpu")
        encode, pooled_fn, real = run_eval._prompt_encoder(args)
        assert real and seen[-1] == (fam, {"device": "cpu"})
        emb, mask = encode("a red fox", 256, 8)
        assert calls[-1] == "a red fox" and emb.shape == (1, 4, 8)
        pooled_fn("a blue fox")
        assert pooled_calls[-1] == "a blue fox"
    args = argparse.Namespace(model="hunyuan", ckpt_dir=None, device="cpu")
    encode, pooled_fn, real = run_eval._prompt_encoder(args)
    assert not real and pooled_fn is None
    emb, mask = encode("a red fox", 16, 8)
    want = gen._random_text("a red fox", 16, 8)
    assert torch.equal(emb, want[0]) and torch.equal(mask, want[1])


# ------------------------------------------------- run_eval against JAX ---

EVAL_ARGS = ["--model", "hunyuan", "--height", "128", "--width", "256",
             "--frame", "16", "--num_steps", "2", "--score"]


def fill_jax_namespace(monkeypatch):
    """JAX's run_eval builds a namespace without the attributes its CLI
    builders read (``mlp_chunk``, ``dispatch_segments``, ``quant``, ...:
    ROADMAP Queue 3), so every family but the CogVideoX one raises
    AttributeError there; the JAX CLI's own defaults fill them in."""
    base = vars(jgen.parse_args([]))
    for name in ("build_hunyuan", "build_wan", "build_cogvideox",
                 "build_flux"):
        orig = getattr(jgen, name)

        def filled(args, orig=orig):
            for k, v in base.items():
                if not hasattr(args, k):
                    setattr(args, k, v)
            return orig(args)
        monkeypatch.setattr(jgen, name, filled)


def record(monkeypatch, module, runners, frames):
    """Record every runner ``module.make_runner`` builds, and the frames
    its generate_batch saves (by file name).  JAX's second sparse runner
    (its score_outputs builds one beside the main run's) is the main
    run's, as in the port: the same outputs, one trace fewer."""
    make = module.make_runner

    def recorded(args):
        if module is jrun_eval and args.mode == "sparse" and runners:
            return runners[0][1], runners[0][2]
        run, is_video = make(args)
        runners.append((args.mode, run, is_video))
        return run, is_video
    monkeypatch.setattr(module, "make_runner", recorded)
    gmod = (generation if module is run_eval else jgeneration)
    save = gmod.save_video

    def saved(arr, path, fps=24):
        frames[os.path.basename(path)] = np.array(arr)
        return save(arr, path, fps)
    monkeypatch.setattr(gmod, "save_video", saved)


def sharp_snapshot(root, gain: float = 8.0):
    """tests/test_torch_io.py's tiny HunyuanVideo snapshot with the q / k
    RMSNorm gains of its video blocks raised to ``gain`` (logits x
    gain^2): at unit gains its attention is nearly flat, the rectified
    sparse output then equals the dense one to within fp32 rounding, and
    diff_vs_dense measures rounding alone."""
    from safetensors.numpy import load_file, save_file
    test_torch_io.write_snapshot(root, "hunyuan")
    tdir = os.path.join(root, "transformer")
    for name in os.listdir(tdir):
        if name.endswith(".safetensors"):
            path = os.path.join(tdir, name)
            sd = load_file(path)
            for k in sd:
                if k.endswith(("attn.norm_q.weight", "attn.norm_k.weight")) \
                        and not k.startswith("context_embedder"):
                    sd[k] = sd[k] * np.float32(gain)
            save_file(sd, path)
    return root


def test_run_eval_matches_jax_on_a_snapshot(tmp_path, monkeypatch):
    """The port's run_eval.main and JAX's, both with --score, on one tiny
    snapshot: JAX's PRNGKey(seed) noise handed to the port, the port's
    pseudo-text to JAX.  The written frames and each runner's last full
    output agree at fp32 2e-4 / 2e-5, diff_vs_dense at rtol 1e-3; the
    port builds two runners (the sparse one reused for scoring)."""
    root = sharp_snapshot(str(tmp_path / "snap"))
    prompts = tmp_path / "p.txt"
    prompts.write_text("the cat, running!\n")
    argv = EVAL_ARGS + ["--ckpt_dir", root, "--prompts", str(prompts)]

    fill_jax_namespace(monkeypatch)
    jload = jpre.load_transformer
    monkeypatch.setattr(jpre, "load_transformer", lambda f, r, **k: jload(
        f, r, dtype="float32", cache=False))
    monkeypatch.setattr(jgen, "_random_text", lambda p, n, d, batch=1: tuple(
        jnp.asarray(x.numpy()) for x in gen._random_text(p, n, d, batch)))
    jrunners, jframes = [], {}
    record(monkeypatch, jrun_eval, jrunners, jframes)
    jrun_eval.main(argv + ["--out_dir", str(tmp_path / "jax")])

    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline
    call = HunyuanVideoPipeline.__call__

    def jax_noise(self, *a, seed=42, generator=None, **k):
        noise = jax.random.normal(
            jax.random.PRNGKey(seed),
            (1, self.model.cfg.in_channels, *self.grid), jnp.float32)
        return call(self, *a, init_latents=torch.from_numpy(
            np.array(noise)), **k)
    monkeypatch.setattr(HunyuanVideoPipeline, "__call__", jax_noise)
    runners, frames = [], {}
    record(monkeypatch, run_eval, runners, frames)
    written, res = run_eval.main(argv + ["--device", "cpu", "--out_dir",
                                         str(tmp_path / "port")])

    assert sorted(frames) == sorted(jframes) == ["the_cat_running-0.mp4"]
    for name, want in jframes.items():
        assert frames[name].shape == want.shape and want.shape[-1] == 3
        np.testing.assert_allclose(frames[name], want, err_msg=name, **FP32)
    assert [r[0] for r in runners] == [r[0] for r in jrunners] == [
        "sparse", "flash"]
    for r, jr in zip(runners, jrunners):
        np.testing.assert_allclose(r[1].last_raw(), jr[1].last_raw(),
                                   err_msg=r[0], **FP32)
    with open(tmp_path / "jax" / "scores.json") as f:
        jres = json.load(f)
    with open(tmp_path / "port" / "scores.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    d, jd = res["diff_vs_dense"], jres["diff_vs_dense"]
    # sparse differs from dense beyond rounding (8e-6 at unit gains)
    assert sorted(d) == sorted(jd) and d["relative_l1"] > 1e-4
    for k in jd:
        np.testing.assert_allclose(d[k], jd[k], rtol=1e-3, err_msg=k)
    assert res["live_metrics"] == jres["live_metrics"]
    assert res["vbench"]["available"] is False
    assert "hash" in res["vision_reward"]["status"]
    assert [os.path.basename(p) for p in written] == [
        f for f in sorted(os.listdir(tmp_path / "jax")) if f != "scores.json"]


def test_score_outputs_scores_full_outputs(tmp_path, monkeypatch):
    """The diff metrics run on the FULL [C,F,H,W] output: a deviation in
    two channels that cancel in the channel-mean preview is seen (JAX
    tests/test_eval.py:163-200); the given sparse runner is used, and only
    a dense one is built."""
    g = np.random.default_rng(0)
    dense = g.normal(size=(1, 4, 3, 8, 8)).astype(np.float32)
    sparse = dense.copy()
    bump = 0.5 * g.uniform(size=(3, 8, 8)).astype(np.float32)
    sparse[0, 2] += bump
    sparse[0, 3] -= bump
    assert np.allclose(sparse[0].mean(axis=0), dense[0].mean(axis=0),
                       atol=1e-6)
    built = []

    def runner(lat):
        def run(prompt, seed):
            return lat[0].mean(axis=0)[..., None]
        run.last_raw = lambda: lat
        return run

    def fake(args):
        built.append(args.mode)
        return runner(dense if args.mode == "flash" else sparse), True

    monkeypatch.setattr(run_eval, "make_runner", fake)
    monkeypatch.setattr(jrun_eval, "make_runner", fake)
    args = argparse.Namespace(model="hunyuan", out_dir=str(tmp_path),
                              loops=1, mode="sparse",
                              real_text_encoders=False, device="cpu")
    res = run_eval.score_outputs(args, ["p0"], str(tmp_path),
                                 run_sparse=runner(sparse))
    assert built == ["flash"]
    want = jrun_eval.score_outputs(args, ["p0"], str(tmp_path))
    assert res["diff_vs_dense"]["relative_l1"] > 1e-3
    assert res["diff_vs_dense"]["ssim"] < 0.999
    for k, v in want["diff_vs_dense"].items():
        np.testing.assert_allclose(res["diff_vs_dense"][k], v, **EXACT)


def test_score_outputs_refuses_text_scores_on_pseudo_text(tmp_path,
                                                          monkeypatch):
    """CLIPScore and VisionReward refuse prompts embedded with the seeded
    pseudo-embedding; VisionReward is inapplicable to images; the dense
    reference covers every prompt, written by a writer only."""
    from rectified_spaattn_tpu_torch.utils.video import save_image
    g = np.random.default_rng(0)
    for i in range(2):
        save_image(g.uniform(size=(16, 16, 3)).astype(np.float32),
                   str(tmp_path / f"p{i}-0.png"))

    def fake(args):
        def run(prompt, seed):
            return torch.rand((16, 16, 3), dtype=torch.float64)
        return run, False

    monkeypatch.setattr(run_eval, "make_runner", fake)
    args = argparse.Namespace(model="flux-upscale", out_dir=str(tmp_path),
                              loops=1, mode="sparse",
                              real_text_encoders=False, device="cpu")
    res = run_eval.score_outputs(args, ["p0", "p1"], str(tmp_path))
    assert res["clip_score"]["available"] is False
    assert "hash" in res["clip_score"]["status"]
    assert "not applicable" in res["vision_reward"]["status"]
    assert res["fid"]["samples"] == {"sparse": 2, "dense": 2}
    assert sorted(os.listdir(tmp_path / "dense_ref")) == ["p0-0.png",
                                                          "p1-0.png"]
    quiet = tmp_path / "quiet"
    quiet.mkdir()
    args.out_dir = str(quiet)
    res = run_eval.score_outputs(args, ["p0"], str(quiet), write=False)
    assert os.listdir(quiet) == [] and res["fid"]["samples"]["dense"] == 0


# --------------------------------------------- every family's builder ---

FAMILY_ARGS = {
    "hunyuan": ["--height", "64", "--width", "64", "--frame", "8"],
    "hunyuan-i2v": ["--height", "64", "--width", "64", "--frame", "8"],
    "wan21-t2v": ["--height", "64", "--width", "64", "--frame", "5"],
    "wan21-i2v": ["--height", "64", "--width", "64", "--frame", "5"],
    "wan22-t2v": ["--height", "64", "--width", "64", "--frame", "5"],
    "wan22-i2v": ["--height", "64", "--width", "64", "--frame", "5"],
    "wan22-ti2v": ["--height", "128", "--width", "128", "--frame", "5"],
    "cogvideox-t2v": ["--height", "64", "--width", "64", "--frame", "9"],
    "cogvideox-i2v": ["--height", "64", "--width", "64", "--frame", "9"],
    "flux-upscale": ["--height", "128", "--width", "128"],
}


@pytest.mark.parametrize("model", run_eval.FAMILIES)
def test_run_eval_main_through_each_builder(model, tmp_path):
    """run_eval.main at --scale 0.05 --device cpu through the family's
    real builder: the net for attributes the builders read that run_eval's
    namespace would lack.  The image family also scores (--score: the
    dense_ref over every prompt, FID's gate, CLIPScore refused on
    pseudo-text)."""
    assert set(FAMILY_ARGS) == set(run_eval.FAMILIES)
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\nthe owl\n" if model == "flux-upscale"
                       else "a fox\n")
    out = tmp_path / "out"
    score = ["--score"] if model == "flux-upscale" else []
    written, res = run_eval.main([
        "--model", model, "--prompts", str(prompts), "--out_dir", str(out),
        "--num_steps", "1", "--scale", "0.05", "--device", "cpu",
        *FAMILY_ARGS[model], *score])
    assert written and all(os.path.exists(p) for p in written)
    if model == "flux-upscale":
        assert sorted(os.listdir(out / "dense_ref")) == sorted(
            os.path.basename(p) for p in written)
        assert res["fid"]["available"] is False
        assert res["fid"]["samples"]["dense"] == 2
        assert "hash" in res["clip_score"]["status"]
        assert "not applicable" in res["vision_reward"]["status"]
        assert np.isfinite(list(res["diff_vs_dense"].values())).all()


def test_eval_entry_points_refuse_without_a_gpu(tmp_path):
    """No path falls back to the CPU: the card is the default of run_eval
    and of the launcher, and without one both raise."""
    from rectified_spaattn_tpu_torch.parallel.multihost import launch_eval
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\n")
    argv = ["--prompts", str(prompts), "--out_dir", str(tmp_path)]
    for entry in (run_eval.main, launch_eval):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(argv)


# ------------------------------------------- dp x tp site and launcher ---

def test_head_parallel_over_dp_and_tp(tmp_path):
    """B = 2, H = 4 over dp 2 x tp 2 gloo ranks: each rank runs one row
    (with its text length) and two heads, and every rank's global output
    equals JAX's single-device site in the joint layout (JAX
    tests/test_parallel.py:74-93) and the port's in the visual one;
    batch_axis None gives the same output, and a batch dp does not divide
    raises, on the same ranks."""
    from rectified_spaattn_tpu_torch.attention import (
        rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.sparse import SparseConfig
    g = np.random.default_rng(12)
    q, k, v = (g.normal(size=(2, 4, 256, 32)).astype(np.float32)
               for _ in range(3))
    tlen = np.array([100, 37], np.int32)
    cases = {"visual": dict(cfg=dict(top_k_floor=1, p_remain=0.4,
                                     layout="visual")),
             "joint": dict(cfg=dict(top_k_floor=1, p_remain=0.4,
                                    layout="joint", text_len=128),
                           text_len_rt=torch.from_numpy(tlen))}
    qkv = dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
               v=torch.from_numpy(v))
    torch.save({n: dict(**qkv, **c) for n, c in cases.items()},
               tmp_path / "dp_in.pt")
    ctx = spawn(workers.dp_tp_worker, 4, tmp_path)
    try:
        want = {"joint": np.asarray(j_rectified(
            *map(jnp.asarray, (q, k, v)), JConfig(**cases["joint"]["cfg"]),
            None, visual_len=128, text_len_rt=jnp.asarray(tlen),
            interpret=True)),
            "visual": rectified_sparse_attention(
                *qkv.values(), SparseConfig(**cases["visual"]["cfg"]), None,
                visual_len=256).numpy()}
    finally:
        join(ctx)
    for r in range(4):
        out = torch.load(tmp_path / f"dp_out_{r}.pt", weights_only=False)
        assert out["mesh"] == {"dp": 2, "tp": 2, "sp": 1}
        for n in cases:
            np.testing.assert_allclose(out[n].numpy(), want[n],
                                       err_msg=f"{n} rank {r}", **SITE)
            torch.testing.assert_close(out[f"{n}_no_batch_axis"], out[n],
                                       rtol=0, atol=0)
        assert "batch % dp == 0" in out["batch_error"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_eval_over_two_gloo_ranks(tmp_path):
    """Two launcher processes (the JAX flags: a tcp coordinator, 2
    processes, ids 0 and 1) at tp 1 over gloo on 3 prompts: rank 0 writes
    prompts 0 and 2, rank 1 prompt 1, each file equal byte for byte to the
    one-process run's."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\nthe owl, at night\na third prompt\n")
    common = ["--model", "hunyuan", "--prompts", str(prompts), "--device",
              "cpu", "--scale", "0.05", "--height", "64", "--width", "64",
              "--frame", "8", "--num_steps", "2"]
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rectified_spaattn_tpu_torch.parallel"
         ".multihost", "--coordinator_address", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(i), *common,
         "--out_dir", str(tmp_path / "multi")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        one, _ = run_eval.main(common + ["--out_dir", str(tmp_path / "one")])
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    lines = []
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, err
        lines.append(json.loads(out.strip().splitlines()[-1]))
    names = [os.path.basename(p) for p in one]
    # the shards: rank 0 prompts 0 and 2, rank 1 prompt 1
    assert [ln["files"] for ln in lines] == [[names[0], names[2]],
                                             [names[1]]]
    assert sorted(os.listdir(tmp_path / "multi")) == sorted(names)
    for name in names:
        with open(tmp_path / "one" / name, "rb") as f, \
                open(tmp_path / "multi" / name, "rb") as g:
            assert f.read() == g.read(), name


def test_launch_eval_explicit_ids_without_a_group(tmp_path):
    """Neither coordinator nor --distributed: the explicit ids stand in
    and no group is made (JAX's single-host smoke)."""
    import torch.distributed as dist
    from rectified_spaattn_tpu_torch.parallel.multihost import launch_eval
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\nthe owl\na third\n")
    grouped = dist.is_initialized()
    got = launch_eval(["--num_processes", "3", "--process_id", "2",
                       "--model", "hunyuan", "--prompts", str(prompts),
                       "--device", "cpu", "--scale", "0.05", "--height",
                       "64", "--width", "64", "--frame", "8", "--num_steps",
                       "1", "--out_dir", str(tmp_path / "o")])
    assert got == (2, 3)
    assert os.listdir(tmp_path / "o") == ["a_third-0.npy"]
    assert dist.is_initialized() == grouped       # no group made


def saved_frames(monkeypatch, out_dir) -> dict:
    """The frames generation saves, as float arrays by their path under
    ``out_dir`` (as eval_worker records them on each rank)."""
    frames = {}
    for name in ("save_video", "save_image"):
        def saved(arr, path, *a, save=getattr(generation, name), **k):
            frames[os.path.relpath(path, out_dir)] = np.array(arr)
            return save(arr, path, *a, **k)
        monkeypatch.setattr(generation, name, saved)
    return frames


def eval_over_ranks(tmp_path, monkeypatch, world, argv, launcher):
    """``argv`` through eval_worker on ``world`` gloo ranks, and without
    its --tp through run_eval.main in this process meanwhile.  Returns
    (each rank's output, the one-process run's frames, directory and
    written paths)."""
    multi, one = tmp_path / "multi", tmp_path / "one"
    torch.save({"argv": argv + ["--out_dir", str(multi)],
                "out_dir": str(multi), "launcher": launcher},
               tmp_path / "eval_in.pt")
    ctx = spawn(workers.eval_worker, world, tmp_path)
    try:
        frames = saved_frames(monkeypatch, str(one))
        i = argv.index("--tp")
        written, _ = run_eval.main(argv[:i] + argv[i + 2:]
                                   + ["--out_dir", str(one)])
    finally:
        join(ctx)
    return [torch.load(tmp_path / f"eval_out_{r}.pt", weights_only=False)
            for r in range(world)], frames, one, written


def test_run_eval_at_tp_2_runs_every_prompt_on_both_ranks(tmp_path,
                                                          monkeypatch):
    """run_eval --tp 2 on two gloo ranks (no launcher: a 1 x 2 mesh), 3
    prompts: both tp ranks run every prompt together (a shard by global
    rank would hand them different prompts inside one head-sharded
    pipeline), rank 0 alone writes, and each prompt's frames equal the
    one-process run's."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\nthe owl, at night\na third prompt\n")
    # --scale 0.1: 2 heads, which tp = 2 shards
    argv = ["--model", "hunyuan", "--prompts", str(prompts), "--device",
            "cpu", "--scale", "0.1", "--height", "64", "--width", "64",
            "--frame", "8", "--num_steps", "2", "--tp", "2"]
    outs, frames, one, written = eval_over_ranks(tmp_path, monkeypatch, 2,
                                                 argv, launcher=False)
    names = [generation.safe_name(p) + "-0.mp4" for p in
             ("a fox", "the owl, at night", "a third prompt")]
    assert sorted(frames) == sorted(names)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in written]
    for out in outs:        # the same prompts, in order, on both tp ranks
        assert [os.path.splitext(os.path.basename(p))[0]
                for p in out["got"][0]] == stems
    assert [os.path.basename(p) for p in outs[0]["got"][0]] == [
        os.path.basename(p) for p in written]
    assert outs[1]["frames"] == {}
    assert sorted(os.listdir(tmp_path / "multi")) == sorted(os.listdir(one))
    assert sorted(outs[0]["frames"]) == sorted(names)
    for name in names:
        np.testing.assert_allclose(outs[0]["frames"][name], frames[name],
                                   err_msg=name, **SITE)


def test_launch_eval_over_dp_2_and_tp_2_with_score(tmp_path, monkeypatch):
    """The launcher over dp 2 x tp 2 gloo ranks with --score on the image
    family, 3 prompts: slice 0 (ranks 0, 1) runs prompts 0 and 2, slice
    1 (ranks 2, 3) prompt 1, tp rank 0 of each slice writes; slice 0
    scores, its dense reference covering all 3 prompts (FID's matched
    sets).  Every file and the dense reference match the one-process
    run's, and so do scores.json's keys and sample counts."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a fox\nthe owl, at night\na third prompt\n")
    argv = ["--model", "flux-upscale", "--prompts", str(prompts),
            "--device", "cpu", "--scale", "0.1", "--height", "128",
            "--width", "128", "--num_steps", "1", "--score", "--tp", "2"]
    outs, frames, one, _ = eval_over_ranks(tmp_path, monkeypatch, 4, argv,
                                           launcher=True)
    names = [generation.safe_name(p) + "-0.png" for p in
             ("a fox", "the owl, at night", "a third prompt")]
    dense = [os.path.join("dense_ref", n) for n in names]
    assert sorted(frames) == sorted(names + dense)
    assert [out["got"] for out in outs] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert outs[1]["frames"] == outs[3]["frames"] == {}
    assert sorted(outs[0]["frames"]) == sorted([names[0], names[2]] + dense)
    assert sorted(outs[2]["frames"]) == [names[1]]
    multi = tmp_path / "multi"
    assert sorted(os.listdir(multi)) == sorted(os.listdir(one))
    assert sorted(os.listdir(multi / "dense_ref")) == sorted(names)
    for out in (outs[0], outs[2]):
        for name, got in out["frames"].items():
            np.testing.assert_allclose(got, frames[name], err_msg=name,
                                       **SITE)
    with open(multi / "scores.json") as f, open(one / "scores.json") as g:
        res, want = json.load(f), json.load(g)
    assert res["fid"]["samples"] == want["fid"]["samples"] == {
        "sparse": 3, "dense": 3}
    assert res["live_metrics"] == want["live_metrics"]
    assert sorted(res["diff_vs_dense"]) == sorted(want["diff_vs_dense"])
    # at this width sparse equals dense to within fp32 rounding, on one
    # process and sharded alike: the metrics say so, not how they compare
    for d in (res["diff_vs_dense"], want["diff_vs_dense"]):
        assert d["relative_l1"] < 1e-5 and d["cosine"] > 1 - 1e-9, d


def test_local_device_spreads_ranks_over_the_cards(monkeypatch):
    """The launcher's device: cuda:LOCAL_RANK under torchrun, else the
    global rank modulo the card count (two ranks share one card), cuda:0
    without a rank; the CPU as asked."""
    from rectified_spaattn_tpu_torch.parallel import local_device
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert local_device("cpu", 3) == torch.device("cpu")
    assert local_device("cuda", 1) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert local_device("cuda", 5) == torch.device("cuda", 1)
    assert local_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert local_device("cuda", 5) == torch.device("cuda", 2)
