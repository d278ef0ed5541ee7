"""The port's host ranges on the profiler's clock (utils/timing.py::span):
which ``rsa.*`` ranges the sparse site and the denoise loops open, how
they nest, and that with no profiler running none is entered and no
number changes."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rectified_spaattn_tpu_torch.attention import (
    modes, rectified_sparse_attention)
from rectified_spaattn_tpu_torch.models.layers import init_random_weights
from rectified_spaattn_tpu_torch.sparse import SparseConfig

BM = 128
SITE_PARTS = ("rsa.plan", "rsa.group", "rsa.attn", "rsa.rectify", "rsa.text")


def spans(prof) -> list:
    """[(start ns, end ns, name)] of the ``rsa.*`` host ranges, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("rsa."))


def named(found, name) -> list:
    return [s for s in found if s[2] == name]


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def site_inputs(group: int, head_chunk: int = 0):
    """A joint-layout call: 3 visual blocks less 50 tokens (the pad
    insert), 1 text block, B = 2 with two runtime text lengths."""
    b, h, d, nq = 2, 2, 64, 3
    vis = nq * BM - 50
    g = np.random.default_rng(group)
    q, k, v = (torch.from_numpy(g.normal(size=(b, h, vis + BM, d))
                                .astype(np.float32)) for _ in range(3))
    cfg = SparseConfig(top_k_floor=1, p_remain=0.3, layout="joint",
                       text_len=BM, group_rows=group, head_chunk=head_chunk)
    nbr = torch.from_numpy(np.random.default_rng(5).uniform(size=(nq, nq))
                           < 0.3)
    kw = dict(visual_len=vis, text_len_rt=torch.tensor([100, 37],
                                                       dtype=torch.int32))
    return (q, k, v, cfg, nbr), kw


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(prof)


@pytest.mark.parametrize("group", [1, 2])
def test_site_spans_nest_inside_one_site(group):
    """One ``rsa.site`` holding each stage once (``rsa.group`` only at
    G > 1), the two list readbacks, K2's (or K1's) and the text rows'
    K1's, inside the kernels' ranges, and the plan's one sync."""
    args, kw = site_inputs(group)
    _, found = traced(lambda: rectified_sparse_attention(*args, **kw))
    (site,) = named(found, "rsa.site")
    want = [p for p in SITE_PARTS if group > 1 or p != "rsa.group"]
    for part in SITE_PARTS:
        got = named(found, part)
        assert len(got) == (part in want), (part, got)
        assert all(inside(s, site) for s in got)
    syncs = named(found, "rsa.sync.lists")
    assert len(syncs) == 2
    (attn,), (text,) = named(found, "rsa.attn"), named(found, "rsa.text")
    assert inside(syncs[0], attn) and inside(syncs[1], text)
    # the plan's text-validity scalar, copied from host memory
    (plan,), (scalar,) = named(found, "rsa.plan"), named(found,
                                                          "rsa.sync.plan")
    assert inside(scalar, plan)
    assert {s[2] for s in found} == {"rsa.site", "rsa.sync.lists",
                                     "rsa.sync.plan", *want}


def test_head_chunked_sites_nest():
    """A head-chunked call is one ``rsa.site`` around one per head tile,
    each holding its own stages."""
    args, kw = site_inputs(2, head_chunk=1)
    _, found = traced(lambda: rectified_sparse_attention(*args, **kw))
    outer, *tiles = named(found, "rsa.site")
    assert len(tiles) == 2 and all(inside(t, outer) for t in tiles)
    for part in SITE_PARTS:
        got = named(found, part)
        assert len(got) == 2
        assert all(sum(inside(s, t) for t in tiles) == 1 for s in got)
    assert len(named(found, "rsa.sync.lists")) == 4


def _no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


@pytest.mark.parametrize("group", [1, 2])
def test_site_output_unchanged_and_no_range_without_profiler(group,
                                                             monkeypatch):
    """The output is bit-identical with and without a profiler, and
    without one the site enters no ``record_function``."""
    args, kw = site_inputs(group)
    with_prof, found = traced(lambda: rectified_sparse_attention(*args, **kw))
    assert found
    _no_record_function(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    plain = rectified_sparse_attention(*args, **kw)
    assert torch.equal(plain, with_prof)


def _hunyuan():
    from rectified_spaattn_tpu_torch.models import (HunyuanVideoConfig,
                                                    HunyuanVideoDiT)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline
    g = np.random.default_rng(4)
    text = np.zeros((1, 128, 32), np.float32)
    text[:, :9] = g.normal(size=(1, 9, 32))
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    init = g.normal(size=(1, 4, 2, 8, 16)).astype(np.float32)
    model = init_random_weights(HunyuanVideoDiT(HunyuanVideoConfig.tiny()),
                                torch.Generator().manual_seed(0))
    pipe = HunyuanVideoPipeline(
        model=model, device="cpu", height=64, width=128, frames=8,
        num_steps=2, sa_drop_rate=0.5, p_remain_rates=0.5, mode="sparse",
        text_len=128, group_rows=2)
    return lambda: pipe(text, mask, init_latents=init)


def _cogvideox():
    from rectified_spaattn_tpu_torch.models import (CogVideoXConfig,
                                                    CogVideoXDiT)
    from rectified_spaattn_tpu_torch.pipelines import CogVideoXPipeline
    g = np.random.default_rng(3)
    init = g.normal(size=(1, 4, 4, 16, 24)).astype(np.float32)
    text = np.zeros((1, 128, 32), np.float32)
    text[:, :5] = g.normal(size=(1, 5, 32))
    model = init_random_weights(CogVideoXDiT(CogVideoXConfig.tiny()),
                                torch.Generator().manual_seed(0))
    # calls 0-1 (step 0) dense, 2-3 (step 1) through the sparse site
    pipe = CogVideoXPipeline(
        model=model, device="cpu", height=128, width=192, frames=25,
        num_steps=2, sa_drop_rate=0.5, p_remain_rates=0.5, text_len=128,
        mode="sparse", sparse_warm_calls=2, group_rows=2)
    return lambda: pipe.denoise(init, text, np.zeros_like(text))


@pytest.mark.parametrize("make", [_hunyuan, _cogvideox],
                         ids=["hunyuan", "cogvideox"])
def test_pipeline_step_spans(make, monkeypatch):
    """2 steps: one ``rsa.step`` and one ``rsa.sync.step`` (at its end)
    a step, one ``rsa.site`` a sparse site call, every range inside a
    step; the latents are bit-identical to a run with no profiler, which
    enters no ``record_function``."""
    run = make()
    calls, site = [], modes.rectified_sparse_attention

    def counted(*a, **kw):
        calls.append(len(calls))
        return site(*a, **kw)

    monkeypatch.setattr(modes, "rectified_sparse_attention", counted)
    got, found = traced(run)
    steps = named(found, "rsa.step")
    ends = named(found, "rsa.sync.step")
    assert len(steps) == len(ends) == 2
    assert all(inside(e, s) for e, s in zip(ends, steps))
    sites = named(found, "rsa.site")
    assert calls and len(sites) == len(calls)
    assert all(any(inside(x, s) for s in steps) for x in found
               if x[2] != "rsa.step")
    # two readbacks a site call; CogVideoX's dense calls (K1 windowed)
    # read their lists back outside any site
    assert sum(any(inside(x, s) for s in sites)
               for x in named(found, "rsa.sync.lists")) == 2 * len(calls)
    # the text refiner's masking scalar: one a refiner block a step
    assert len(named(found, "rsa.sync.refiner")) == (2 if make is _hunyuan
                                                     else 0)
    _no_record_function(monkeypatch)
    assert torch.equal(make()(), got)
