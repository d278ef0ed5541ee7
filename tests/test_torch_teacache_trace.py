"""The port's TeaCache tracing and calibration against the JAX package on
the CPU: the trace JSON the tiny HunyuanVideo and Wan pipelines write
under ``trace_to`` (decisions and keys exact, ``raw`` within fp32 rtol
1e-3 / atol 1e-4, the pipelines' tolerance of tests/test_models.py:65),
the replay of every committed ``bench_traces/*.json`` through both
controllers decision for decision, ``schedule_from_trace`` and the
``cache/calibrate.py`` functions on those traces, the Hunyuan
``teacache_signal_stride`` and the COEFFICIENTS table."""

import glob
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.cache import calibrate as jcal
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JHPipe
from rectified_spaattn_tpu_torch.cache import calibrate as cal
from rectified_spaattn_tpu_torch.cache import teacache as tc
from rectified_spaattn_tpu_torch.cache import schedule_from_trace
from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

import test_torch_pipeline as hun
import test_torch_wan as wan

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACES = sorted(glob.glob(os.path.join(ROOT, "bench_traces", "*.json")))


def assert_same_trace(got: list, want: list):
    """Record for record: the same keys, metas and decisions exactly, the
    raw signals within TOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        if "meta" in w:
            assert g == w
            continue
        assert {k: v for k, v in g.items() if k != "raw"} == \
            {k: v for k, v in w.items() if k != "raw"}
        assert (g["raw"] is None) == (w["raw"] is None)
        if w["raw"] is not None:
            np.testing.assert_allclose(g["raw"], w["raw"], **TOL)


def test_coefficients_match_jax():
    assert tc.COEFFICIENTS == jtc.COEFFICIENTS
    assert list(tc.COEFFICIENTS) == list(jtc.COEFFICIENTS)


@pytest.mark.parametrize("stride", [1, 2])
def test_hunyuan_pipeline_trace_matches_jax(stride, tmp_path):
    """3 steps with TeaCache at a threshold where a call skips (the
    fixture of test_torch_pipeline.py); teacache_signal_stride 2 keeps
    every other signal token on both sides."""
    jmod, params, tmod, text, mask = hun.tiny_models()
    kw = dict(height=64, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="vanilla", enable_teacache=True,
              rel_l1_thresh=0.8, text_len=128, teacache_signal_stride=stride)
    jpipe = JHPipe(model=jmod, params=params, interpret=True, **kw)
    pipe = HunyuanVideoPipeline(model=tmod, device="cpu", **kw)
    init = np.random.default_rng(4).normal(
        size=(1, 4, *jpipe.grid)).astype(np.float32)
    jpath, path = tmp_path / "jax.json", tmp_path / "port.json"
    with jtc.trace_to(str(jpath)):
        want_lat = np.asarray(jpipe(jnp.asarray(text), jnp.asarray(mask),
                                    init_latents=jnp.asarray(init)))
    with tc.trace_to(str(path)) as live:
        got_lat = pipe(text, mask, init_latents=init).numpy()
        assert live is tc.TRACE and len(live) == 1 + 3
    assert tc.TRACE is None
    want, got = json.loads(jpath.read_text()), json.loads(path.read_text())
    assert_same_trace(got, want)
    assert [r["compute"] for r in got if "call" in r] == [True, False, True]
    np.testing.assert_allclose(got_lat, want_lat, **TOL)


def test_hunyuan_signal_stride_shrinks_the_stored_signal():
    _, _, tmod, text, mask = hun.tiny_models()
    kw = dict(height=64, width=128, frames=8, num_steps=2, mode="vanilla",
              enable_teacache=True, text_len=128)
    full = HunyuanVideoPipeline(model=tmod, device="cpu", **kw)
    half = HunyuanVideoPipeline(model=tmod, device="cpu",
                                teacache_signal_stride=2, **kw)
    full(text, mask)
    half(text, mask)
    a = full.teacache.states[0].previous_modulated
    b = half.teacache.states[0].previous_modulated
    torch.testing.assert_close(b, a[:, ::2], rtol=0, atol=0)


def test_wan_pipeline_trace_matches_jax(tmp_path):
    """The tiny sparse CFG pipeline of test_torch_wan.py: two streams,
    ret / cutoff windows in the meta record."""
    kw = dict(height=192, width=240, frames=5, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="sparse", enable_teacache=True,
              teacache_thresh=0.3, warm_layers=1, warm_calls=2)
    jpipe, pipe = wan.pipeline_pair(**kw)
    g = np.random.default_rng(14)
    init = g.normal(size=(1, 4, *pipe.grid)).astype(np.float32)
    text_c = g.normal(size=(1, 6, 32)).astype(np.float32)
    text_u = np.zeros_like(text_c)
    jpath, path = tmp_path / "jax.json", tmp_path / "port.json"
    with jtc.trace_to(str(jpath)):
        jpipe.denoise(jnp.asarray(init), jnp.asarray(text_c),
                      jnp.asarray(text_u))
    with tc.trace_to(str(path)):
        pipe.denoise(init, text_c, text_u)
    want, got = json.loads(jpath.read_text()), json.loads(path.read_text())
    assert_same_trace(got, want)
    assert got[0]["meta"]["cfg_streams"] == 2
    assert False in [r["compute"] for r in got if "call" in r]


def test_replayed_schedule_trace_and_schedule_from_trace(tmp_path):
    """A forced schedule writes ``forced`` records with no raw; the file
    reads back as the same schedule on both sides."""
    sched = [True, False, True, False]
    kw = dict(thresh=0.1, num_steps=4, forced_schedule=sched)
    jpath, path = tmp_path / "jax.json", tmp_path / "port.json"
    x = np.ones((1, 4), np.float32)
    with jtc.trace_to(str(jpath)):
        ref = jtc.TeaCache(**kw)
        [ref.should_compute(jnp.asarray(x)) for _ in range(5)]
    with tc.trace_to(str(path)):
        ours = tc.TeaCache(**kw)
        [ours.should_compute(torch.from_numpy(x)) for _ in range(5)]
    assert json.loads(path.read_text()) == json.loads(jpath.read_text())
    assert schedule_from_trace(str(path)) == \
        jtc.schedule_from_trace(str(jpath)) == sched + [True]
    with tc.trace_to(None) as live:
        assert live is None and tc.TRACE is None
    with tc.trace_to(str(path)):
        with pytest.raises(RuntimeError, match="nest"):
            with tc.trace_to(str(tmp_path / "inner.json")):
                pass


def _segments(records):
    """(meta, call records) per TeaCache instance of a trace: the call
    counter restarts at 0 for each instance (Wan2.2 A14B traces hold
    two)."""
    metas = [r["meta"] for r in records if "meta" in r]
    segs = []
    for r in records:
        if "call" in r:
            if r["call"] == 0 or not segs:
                segs.append([])
            segs[-1].append(r)
    assert len(segs) == len(metas)
    return list(zip(metas, segs))


def _signals(meta, calls):
    """Per-stream positive scalars whose successive rel-L1 ratios are the
    recorded raws (the replay of tests/test_teacache_schedule_parity.py)."""
    vals = [1.0] * meta["cfg_streams"]
    out = []
    for r in calls:
        if r["raw"] is not None:
            vals[r["stream"]] *= 1.0 + r["raw"]
        out.append(np.full((8,), vals[r["stream"]], np.float32))
    return out


@pytest.mark.parametrize("path", TRACES, ids=os.path.basename)
def test_bench_trace_replays_through_both_controllers(path):
    """Each instance's recorded signal sequence drives the port's and the
    JAX TeaCache (the recorded raws already carry signal_scale, so both
    run at scale 1): decision for decision equal to each other and to the
    recorded schedule; the stats agree."""
    with open(path) as f:
        records = json.load(f)
    for meta, calls in _segments(records):
        kw = dict(thresh=meta["thresh"], num_steps=meta["num_steps"],
                  coefficients=meta["coefficients"],
                  ret_steps=meta["ret_steps"],
                  cutoff_steps=meta["cutoff_steps"],
                  cfg_streams=meta["cfg_streams"])
        ours, ref = tc.TeaCache(**kw), jtc.TeaCache(**kw)
        sigs = _signals(meta, calls)
        got = [ours.should_compute(torch.from_numpy(s)) for s in sigs]
        want = [ref.should_compute(jnp.asarray(s)) for s in sigs]
        assert got == want == [bool(r["compute"]) for r in calls]
        assert ours.stats() == ref.stats()


@pytest.mark.parametrize("path", TRACES, ids=os.path.basename)
def test_calibrate_matches_jax_on_bench_traces(path):
    """schedule_from_trace, simulate_schedule (at scale 1 and 0.5),
    skip_rate, trace_raws (single-instance traces), solve_signal_scale (a
    200-point grid) and realistic_raw_window give equal results."""
    assert schedule_from_trace(path) == jtc.schedule_from_trace(path)
    with open(path) as f:
        records = json.load(f)
    for meta, calls in _segments(records):
        meta = {"signal_scale": 1.0, **meta}
        raws = [None if r["raw"] is None else r["raw"] / meta["signal_scale"]
                for r in calls]
        for scale in (1.0, 0.5):
            sim = cal.simulate_schedule(meta, raws, scale)
            assert sim == jcal.simulate_schedule(meta, raws, scale)
            assert cal.skip_rate(sim) == jcal.skip_rate(sim)
        assert cal.solve_signal_scale(meta, raws, 0.5, samples=200) == \
            jcal.solve_signal_scale(meta, raws, 0.5, samples=200)
        np.testing.assert_array_equal(
            cal.realistic_raw_window(meta["coefficients"], meta["thresh"]),
            jcal.realistic_raw_window(meta["coefficients"], meta["thresh"]))
    if len(_segments(records)) == 1:
        assert cal.trace_raws(records) == jcal.trace_raws(records)
    else:
        with pytest.raises(ValueError, match="single-instance"):
            cal.trace_raws(records)


def test_bench_traces_are_all_here():
    assert len(TRACES) == 17


def test_simulate_schedule_matches_the_controller(tmp_path):
    """The simulation over a trace's raws (trace_raws rescales them to
    scale 1) replays the port's own TeaCache decisions: two streams and a
    signal scale that moves signals across the threshold."""
    g = np.random.default_rng(3)
    vals, sigs = [1.0, 1.0], []
    for i in range(12):
        vals[i % 2] *= 1.0 + float(g.uniform(0.05, 0.3))
        sigs.append(torch.full((8,), vals[i % 2]))
    path = tmp_path / "trace.json"
    with tc.trace_to(str(path)):
        tea = tc.TeaCache(thresh=0.2, num_steps=12,
                          coefficients="identity", ret_steps=2,
                          cutoff_steps=10, cfg_streams=2, signal_scale=0.7)
        got = [tea.should_compute(s) for s in sigs]
    meta, raws = cal.trace_raws(json.loads(path.read_text()))
    assert True in got[2:10] and False in got
    assert cal.simulate_schedule(meta, raws, 0.7) == got


def test_record_residual_matches_jax():
    """record_residual stores the bf16 residuals of both streams, which
    apply_residual adds back, as JAX's does."""
    g = np.random.default_rng(5)
    h_in, h_out, c_in, c_out = (g.normal(size=(1, 6, 4)).astype(np.float32)
                                for _ in range(4))
    x, ctx = (g.normal(size=(1, 6, 4)).astype(np.float32) for _ in range(2))
    ours, ref = tc.TeaCache(0.1, 4), jtc.TeaCache(0.1, 4)
    ours.should_compute(torch.from_numpy(x))
    ref.should_compute(jnp.asarray(x))
    ours.record_residual(*map(torch.from_numpy, (h_in, h_out, c_in, c_out)))
    ref.record_residual(*map(jnp.asarray, (h_in, h_out, c_in, c_out)))
    got = ours.apply_residual(torch.from_numpy(x), torch.from_numpy(ctx))
    want = ref.apply_residual(jnp.asarray(x), jnp.asarray(ctx))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
