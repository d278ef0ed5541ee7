"""The port's CogVideoX and Flux end-to-end benches and its TeaCache
calibration (rectified_spaattn_tpu_torch/bench/e2e_cog.py, e2e_flux.py,
calibrate_teacache.py):

- ``run(small=True, device="cpu")``'s sparse and flash latents against
  the JAX pipeline at the bench's settings (sparse warm calls zeroed;
  every block of the Flux slice sparse), with the scripts' own random
  trees (tests/_torch_e2e_common.py), at 1e-3 / 1e-4;
- the calibration solve on one shared trace, bit for bit, and a
  calibration run that leaves bench_traces/ untouched.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from _torch_e2e_common import (ROOT, TOL, f32_tree, noise, script,  # noqa
                               small_pools, small_port_pools)
from rectified_spaattn_tpu_torch.bench import e2e_weights as ew

torch.set_num_threads(1)


def test_cog_bench_matches_jax():
    from rectified_spaattn_tpu.models import cogvideox as jc
    from rectified_spaattn_tpu.pipelines import CogVideoXPipeline as JPipe
    from rectified_spaattn_tpu_torch.bench import e2e_cog
    lat = {}
    line = e2e_cog.run(small=True, device="cpu", latents_out=lat)
    h, w, f = e2e_cog.SMALL_VIDEO
    assert line["blocks"] == e2e_cog.SMALL["num_blocks"]
    jcfg = jc.CogVideoXConfig(**e2e_cog.SMALL)
    jm = jc.CogVideoXDiT(jcfg)
    params = f32_tree(script("bench_e2e_cog").host_bf16_params(jm, jcfg))
    # the port's 256-slot text tail: the 226 tokens, then zeros
    pad = lambda x: np.pad(x, ((0, 0), (0, 30), (0, 0)))
    text = pad(ew.random_text((1, 226, jcfg.text_dim), 0, "cpu").numpy())
    neg = pad(ew.random_text((1, 226, jcfg.text_dim), 1, "cpu").numpy())
    for mode in ("sparse", "flash"):
        jp = JPipe(model=jm, params=params, height=h, width=w, frames=f,
                   num_steps=1, sa_drop_rate=0.85, p_remain_rates=0.05,
                   mode=mode, sparse_warm_calls=0, interpret=True)
        init = noise((1, 16, *jp.grid))
        want = np.asarray(jp.denoise(*map(jnp.asarray, (init, text, neg))))
        np.testing.assert_allclose(lat[mode].numpy(), want, **TOL)


def test_flux_bench_matches_jax(small_pools, small_port_pools):
    from rectified_spaattn_tpu.models import flux as jf
    from rectified_spaattn_tpu.pipelines import FluxPipeline as JPipe
    from rectified_spaattn_tpu_torch.bench import e2e_flux
    lat = {}
    line = e2e_flux.run(small=True, device="cpu", latents_out=lat)
    sh = e2e_flux.SMALL_SHAPE
    assert line["gate"] == [3, 3]       # every block of the slice sparse
    jcfg = jf.FluxConfig(num_dual_blocks=sh["dual"],
                         num_single_blocks=sh["single"], **e2e_flux.SMALL)
    jm = jf.FluxDiT(jcfg)
    params = f32_tree(script("bench_e2e_flux").build_params(jm, jcfg, 0,
                                                            False))
    text = ew.random_text((1, 512, jcfg.text_dim), 0, "cpu").numpy()
    pooled = ew.random_text((1, jcfg.pooled_dim), 1, "cpu").numpy()
    mask = np.ones((1, 512), bool)
    for mode in ("sparse", "flash"):
        jp = JPipe(model=jm, params=params, height=sh["size"],
                   width=sh["size"], num_steps=1, sa_drop_rate=0.9,
                   p_remain_rates=0.05, mode=mode, sparse_layer_gate=(3, 3),
                   interpret=True)
        init = noise((1, jp.gh * jp.gw, jcfg.in_channels))
        want = np.asarray(jp.denoise(*map(jnp.asarray,
                                          (init, text, mask, pooled))))
        np.testing.assert_allclose(lat[mode].numpy(), want, **TOL)


# ------------------------------------------------------------ calibrate ---

def _tree_digest(path):
    h = hashlib.sha1()
    for dirpath, _, files in sorted(os.walk(path)):
        for name in sorted(files):
            with open(os.path.join(dirpath, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_calibration_solve_matches_jax_and_leaves_bench_traces(tmp_path):
    """The port's calibration of one family at 10 steps: its probe trace's
    raws, solved scale and raw window bit for bit against JAX's
    cache/calibrate.py on that same trace; the calibrated trace and the
    summary under --out; nothing under bench_traces/ written."""
    from rectified_spaattn_tpu.cache import calibrate as jcal
    from rectified_spaattn_tpu_torch.bench import calibrate_teacache as ct
    traces = os.path.join(ROOT, "bench_traces")
    before = _tree_digest(traces)
    assert ct.DEFAULT_OUT.startswith(os.path.join(ROOT, "outputs"))
    out = tmp_path / "calib"
    summary = ct.main(["--device", "cpu", "--small", "--families",
                       "cogvideox-t2v", "--out", str(out)])
    entry = summary["cogvideox-t2v"]
    with open(out / "work" / "probe_cogvideox-t2v.json") as f:
        meta, raws = jcal.trace_raws(json.load(f))
    assert (entry["signal_scale"], entry["predicted_skip_rate"]) \
        == jcal.solve_signal_scale(meta, raws, entry["target_skip_rate"])
    assert entry["realistic_raw_window"] == list(
        jcal.realistic_raw_window(meta["coefficients"], meta["thresh"]))
    assert entry["achieved_skip_rate"] == entry["predicted_skip_rate"]
    assert (out / entry["trace"]).is_file()
    with open(out / "calibration" / "summary.json") as f:
        assert json.load(f) == summary
    assert _tree_digest(traces) == before
