"""The port's scheduler, TeaCache and HunyuanVideo pipeline against the JAX
package: the tiny pipeline from the same numpy noise and text, the same
weights (bridged), call-for-call TeaCache decisions, latents within fp32
rtol 1e-3 / atol 1e-4 (tests/test_models.py:65).  Also the CLI on the CPU
and the port's isolation from JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models.hunyuan import (
    HunyuanVideoConfig as JConfig, HunyuanVideoDiT as JDiT)
from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JPipe
from rectified_spaattn_tpu.pipelines import schedulers as jsched
from rectified_spaattn_tpu_torch.cache import TeaCache, rel_l1_signal
from rectified_spaattn_tpu_torch.models import (HunyuanVideoConfig,
                                                HunyuanVideoDiT,
                                                load_flax_params)
from rectified_spaattn_tpu_torch.pipelines import (FlowMatchEulerScheduler,
                                                   HunyuanVideoPipeline,
                                                   flow_shift_timesteps)

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flow_match_scheduler():
    np.testing.assert_allclose(flow_shift_timesteps(7, 7.0),
                               jsched.flow_shift_timesteps(7, 7.0))
    ours, ref = FlowMatchEulerScheduler(5), jsched.FlowMatchEulerScheduler(5)
    np.testing.assert_allclose(ours.timesteps, ref.timesteps)
    x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    v = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ours.step(torch.from_numpy(v), torch.from_numpy(x), 2).numpy(),
        np.asarray(ref.step(jnp.asarray(v), jnp.asarray(x), 2)), **TOL)


def test_site_and_pipeline_helpers_match_jax():
    from rectified_spaattn_tpu.pipelines import base as jbase
    from rectified_spaattn_tpu_torch.pipelines import base
    kw = dict(sa_drop_rate=0.8, p_remain=0.3, layout="joint", text_len=256,
              group_rows=2, head_chunk=2)
    jsite, jl2h, jh2l = jbase.build_site(4, 6, 10, **kw)
    site, l2h, h2l = base.build_site(4, 6, 10, device="cpu", **kw)
    assert vars(site.cfg) == vars(jsite.cfg)
    assert site.visual_len == jsite.visual_len
    np.testing.assert_array_equal(site.neighbor_mask.numpy(),
                                  np.asarray(jsite.neighbor_mask))
    np.testing.assert_array_equal(l2h.numpy(), np.asarray(jl2h))
    np.testing.assert_array_equal(h2l.numpy(), np.asarray(jh2l))
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    for axis in (1, -1, 0):
        np.testing.assert_array_equal(
            base.pad_tokens(torch.from_numpy(x), 4, axis).numpy(),
            np.asarray(jbase.pad_tokens(jnp.asarray(x), 4, axis)))
    np.testing.assert_allclose(
        base.classifier_free_guidance(torch.tensor(2.0), torch.tensor(1.0),
                                      6.0).item(),
        float(jbase.classifier_free_guidance(2.0, 1.0, 6.0)))
    lin = torch.nn.Linear(2, 2)
    assert base.param_compute_dtype(lin) == torch.float32
    assert base.param_compute_dtype(lin.to(torch.bfloat16)) == torch.bfloat16


def test_teacache_decisions_match_jax():
    """The same signal sequence through both controllers, including the
    forced schedule replay."""
    g = np.random.default_rng(2)
    sigs = [g.normal(size=(1, 8, 4)).astype(np.float32) * (1 + 0.01 * i)
            for i in range(8)]
    for kw in (dict(thresh=0.15, num_steps=8, coefficients="hunyuan-video"),
               dict(thresh=0.3, num_steps=8, coefficients="identity"),
               dict(thresh=0.1, num_steps=8,
                    forced_schedule=[True, False, True, False])):
        ours, ref = TeaCache(**kw), jtc.TeaCache(**kw)
        got = [ours.should_compute(torch.from_numpy(s)) for s in sigs]
        want = [ref.should_compute(jnp.asarray(s)) for s in sigs]
        assert got == want == ours.decisions, kw
        assert ours.stats() == ref.stats()
    a, b = sigs[0], sigs[1]
    assert float(rel_l1_signal(torch.from_numpy(a), torch.from_numpy(b))) \
        == pytest.approx(float(jtc.rel_l1_signal(jnp.asarray(a),
                                                 jnp.asarray(b))), rel=1e-5)


def tiny_models():
    cfg = JConfig.tiny()
    g = np.random.default_rng(0)
    text = g.normal(size=(1, 128, cfg.text_dim)).astype(np.float32)
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    jmod = JDiT(cfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.in_channels, 2, 8, 8)),
        jnp.array([0.0]), jnp.asarray(text), jnp.asarray(mask),
        jnp.array([6000.0]), None, None))
    tmod = load_flax_params(HunyuanVideoDiT(HunyuanVideoConfig.tiny()),
                            params)
    return jmod, params, tmod, text, mask


@pytest.mark.parametrize("mode", ["vanilla", "sparse"])
def test_tiny_pipeline_matches_jax(mode, tmp_path):
    """3 steps with TeaCache at a threshold where the middle call skips;
    the decisions match call for call and the latents agree."""
    jmod, params, tmod, text, mask = tiny_models()
    kw = dict(height=64, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode=mode, enable_teacache=True,
              rel_l1_thresh=0.8, text_len=128, group_rows=2)
    jpipe = JPipe(model=jmod, params=params, interpret=True, **kw)
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
    assert pipe.teacache.decisions == jdec
    assert False in jdec                  # the skip path ran
    assert pipe.teacache_stats == jpipe.teacache_stats
    np.testing.assert_allclose(got, want, **TOL)


def test_pipeline_noise_from_generator():
    _, _, tmod, text, mask = tiny_models()
    pipe = HunyuanVideoPipeline(model=tmod, height=64, width=64, frames=8,
                                num_steps=1, mode="vanilla", text_len=128,
                                device="cpu")
    a = pipe(text, mask, seed=3)
    b = pipe(text, mask, seed=3)
    gen = torch.Generator().manual_seed(3)
    c = pipe(text, mask, generator=gen)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert pipe.step_seconds and pipe.denoise_seconds > 0


def test_cli_runs_on_cpu(tmp_path, capsys):
    from rectified_spaattn_tpu_torch.cli.generate import main
    res = main(["--model", "hunyuan", "--device", "cpu", "--scale", "0.05",
                "--height", "64", "--width", "64", "--frame", "8",
                "--num_steps", "2", "--enable_teacache", "--group_rows", "2",
                "--density", "--out_dir", str(tmp_path)])
    out = np.load(res["output"])
    assert out.shape == (1, 16, 2, 8, 8) and np.isfinite(out).all()
    assert res["teacache"] == {"skipped": 0, "computed": 2}
    assert 0 < res["density"] <= 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    # every --model is ported; the TPU lever dispatch_segments is refused,
    # before anything is built
    with pytest.raises(NotImplementedError, match="--dispatch_segments"):
        main(["--model", "hunyuan", "--device", "cpu",
              "--dispatch_segments", "2"])
    # --image conditions hunyuan-i2v (tests/test_torch_i2v.py holds it
    # against JAX)
    img = str(tmp_path / "x.npy")
    np.save(img, np.random.default_rng(0).uniform(0, 255, (48, 40, 3)))
    res = main(["--model", "hunyuan-i2v", "--device", "cpu", "--scale",
                "0.05", "--height", "64", "--width", "64", "--frame", "8",
                "--num_steps", "2", "--image", img,
                "--out_dir", str(tmp_path)])
    out = np.load(res["output"])
    assert out.shape == (1, 16, 2, 8, 8) and np.isfinite(out).all()


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from rectified_spaattn_tpu_torch.cli.generate import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--scale", "0.05", "--height", "64", "--width", "64",
              "--frame", "8", "--num_steps", "1"])
    _, _, tmod, _, _ = tiny_models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HunyuanVideoPipeline(model=tmod, height=64, width=64, frames=8)


def test_port_imports_no_jax():
    """Import the whole port with jax blocked; no module of the JAX
    package may load."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "import rectified_spaattn_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'rectified_spaattn_tpu' or "
        "m.startswith('rectified_spaattn_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 69
