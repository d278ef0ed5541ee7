"""The port's Wan2.1 against the benchmark's plain float32 reference
(perfbench/reference/wan.py, which imports nothing of the port) on seeded
random weights at a tiny size: the block, the whole forward, the
visual-layout site with first-frame retention, one call of the pipeline
through its warm gate, and the faults that the comparison has to catch.
Also the ``rsa.dense`` / ``rsa.cross`` ranges of pipelines/wan.py.

Tolerance: both sides compute in float32 on the CPU and differ only in
the order of their sums (the port's kernels' plain versions walk keys
block by block, the reference takes one softmax), so outputs agree to
~1e-6 of their norm; 1e-5 leaves room for that, and a broken stage
moves them by 1e-3 and more."""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from perfbench import inputs
from perfbench.reference import common, wan as ref
from rectified_spaattn_tpu_torch.attention import attention, rectified
from rectified_spaattn_tpu_torch.models.wan import WanConfig, WanDiT
from rectified_spaattn_tpu_torch.pipelines import WanPipeline
from rectified_spaattn_tpu_torch.pipelines.base import build_site
from rectified_spaattn_tpu_torch.sparse import build_sparse_plan
from rectified_spaattn_tpu_torch.utils import timing

SEED = 2 ** 31 + 777
# 2 x 16 x 30 = 960 tokens: 8 blocks of 128 (64 pad rows), the first
# frame the first 3 (7 whole blocks over 2 frames)
C = dict(in_channels=4, out_channels=4, hidden_dim=64, heads=2, head_dim=32,
         num_blocks=3, ffn_dim=128, patch_size=(1, 2, 2), text_dim=32,
         freq_dim=32, rope_axes_dim=(12, 10, 10), rope_theta=10000.0,
         text_len=16, sa_drop_rate=0.75, p_remain=0.3, warm_layers=2,
         warm_calls=4, first_frame_retention=True, flow_shift=5.0,
         num_steps=10)
SHAPE = (1, 4, 2, 32, 60)
TOL = 1e-5


def rel(got, want):
    got, want = got.detach().double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def tiny():
    weights = inputs.draw_weights(ref.param_table(C), SEED, "cpu",
                                  torch.float32)
    cfg = WanConfig(**{k: C[k] for k in (
        "in_channels", "out_channels", "hidden_dim", "heads", "head_dim",
        "ffn_dim", "patch_size", "text_dim", "freq_dim", "rope_axes_dim",
        "rope_theta")}, num_blocks=C["num_blocks"])
    model = WanDiT(cfg)
    model.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(3)
    latents = inputs.smooth_latents(SHAPE, SEED, "cpu")
    text = F.pad(torch.randn(10, C["text_dim"], generator=g), (0, 0, 0, 6))
    return model, ref.Model(C, weights, SHAPE, "cpu"), latents, text


def vanilla(q, k, v):
    return attention(q, k, v, mode="vanilla")


def test_text_embedder_is_the_published_tanh_gelu(tiny):
    model = tiny[0]
    x = torch.randn(1, 5, C["text_dim"])
    e = model.text_embedder
    want = e.fc2(F.gelu(e.fc1(x), approximate="tanh"))
    torch.testing.assert_close(e(x), want, rtol=0, atol=0)


def test_block_matches_reference(tiny):
    """CrossAttnBlock: modulation from the block's table plus the shared
    projection, full-width q / k RMSNorm, interleaved RoPE, the affine
    cross norm, the FFN; dense self-attention."""
    model, rm, _, _ = tiny
    g = torch.Generator().manual_seed(5)
    s = 960
    x, ctx = (torch.randn(n, C["hidden_dim"], generator=g)
              for n in (s, C["text_len"]))
    temb6 = 0.3 * torch.randn(6, C["hidden_dim"], generator=g)
    for k in range(C["num_blocks"]):
        got = model.blocks[k](x[None], ctx[None], temb6[None],
                              (rm.cos, rm.sin), vanilla, vanilla)[0]
        want = rm.block(k, x, ctx, temb6, False, [])
        assert rel(got, want) < TOL, k


def test_forward_matches_reference(tiny):
    """WanDiT.forward (dense everywhere) against a warm call of the
    reference, at two steps of the schedule."""
    model, rm, latents, text = tiny
    site, l2h, h2l = build_site(2, 16, 30, sa_drop_rate=0.75, p_remain=0.3,
                                layout="visual", device="cpu")
    for i in (0, 7):
        t = torch.tensor([rm.sigmas[i] * 1000.0], dtype=torch.float32)
        got = model(latents, t, text[None], hilbert_to_linear=h2l,
                    linear_to_hilbert=l2h)
        want = rm.call(latents, i, text, [], call_index=0)
        assert rel(got, want) < TOL, i


def _site_inputs(grid, h=2, d=32, seed=0):
    torch.manual_seed(seed)
    sv = grid[0] * grid[1] * grid[2]
    # smooth rows, so that the plan has structure to find
    base = torch.randn(1, h, sv // 16 + 1, d).repeat_interleave(16, dim=2)
    return sv, [(base[:, :, :sv] + 0.3 * torch.randn(1, h, sv, d)).float()
                for _ in range(3)]


@pytest.mark.parametrize("grid", [(2, 16, 30), (3, 32, 32)])
def test_visual_site_matches_reference(grid, monkeypatch):
    """The visual-layout site (pooled softmax over the visual blocks,
    GAPR, top-p with the floor, neighbours, first-frame retention, the
    rectification): the same block mask, and outputs to 1e-5."""
    site, _, _ = build_site(*grid, sa_drop_rate=0.75, p_remain=0.3,
                            layout="visual", first_frame_retention=True,
                            device="cpu")
    sv, (q, k, v) = _site_inputs(grid)
    masks = []
    orig = rectified.build_sparse_plan

    def keep(*a, **kw):
        p = orig(*a, **kw)
        masks.append(p.block_mask)
        return p
    monkeypatch.setattr(rectified, "build_sparse_plan", keep)
    pad = (-sv) % 128
    got = rectified.rectified_sparse_attention(
        *(F.pad(x, (0, 0, 0, pad)) for x in (q, k, v)), site.cfg,
        site.neighbor_mask, visual_len=sv)[:, :, :sv]
    blocks = sv // 128
    want, mask = ref.rectified_attention(
        q[0], k[0], v[0], common.Numerics({}), neighbors=site.neighbor_mask,
        p_remain=0.3, floor=int(0.25 * blocks), retained=blocks // grid[0],
        rows_per_step=5)
    assert site.cfg.first_frame_blocks == blocks // grid[0]
    assert torch.equal(mask, masks[0][0])
    assert rel(got[0], want) < TOL


def test_broken_retention_fails_the_plan():
    """Without first-frame retention the port's mask loses pairs that
    the reference keeps: the first frame's blocks are not all neighbours
    and top-p does not pick them all."""
    grid = (3, 32, 32)
    site, _, _ = build_site(*grid, sa_drop_rate=0.75, p_remain=0.3,
                            layout="visual", first_frame_retention=True,
                            device="cpu")
    broken = dataclasses.replace(site.cfg, first_frame_blocks=0)
    sv, (q, k, v) = _site_inputs(grid)
    plan = build_sparse_plan(q, k, v, broken,
                             neighbor_mask=site.neighbor_mask)
    blocks = sv // 128
    _, want = ref.rectified_attention(
        q[0], k[0], v[0], common.Numerics({}), neighbors=site.neighbor_mask,
        p_remain=0.3, floor=int(0.25 * blocks), retained=blocks // grid[0])
    missing = want & ~plan.block_mask[0]
    assert missing.sum() > 0
    assert not missing[:, blocks // grid[0]:].any()      # only there


def _pipeline(model, **kw):
    return WanPipeline(model, height=256, width=480, frames=5,
                       num_steps=C["num_steps"], sa_drop_rate=0.75,
                       p_remain_rates=0.3, flow_shift=5.0, warm_layers=2,
                       warm_calls=4, device="cpu", **kw)


def _one_call(pipe, latents, text, i, sparse=True):
    t = float(pipe._scheduler(C["num_steps"]).timesteps[i])
    x, ctx, ctx_img, temb, temb6, rope = pipe._embed(
        latents, torch.full((1,), t), text[None], None)
    return pipe._head(pipe._run_blocks(x, ctx, ctx_img, temb6, rope, sparse),
                      temb)


def test_pipeline_call_matches_reference(tiny):
    """One sparse call of WanPipeline: layers 0-1 dense (the warm gate),
    layer 2 through the site; and with the gate broken (every layer
    sparse) the comparison fails."""
    model, rm, latents, text = tiny
    pipe = _pipeline(model)
    want = rm.call(latents, 6, text, [], call_index=12)
    assert rel(_one_call(pipe, latents, text, 6), want) < TOL
    pipe.warm_layers = 0
    assert rel(_one_call(pipe, latents, text, 6), want) > 1e-3


def test_dense_and_cross_ranges_with_their_sizes(tiny, monkeypatch):
    """While a profiler records, each warm-gate self-attention call is a
    ``rsa.dense`` range and each cross-attention call a ``rsa.cross``
    range, named with the call's sizes; without one no range is
    entered."""
    model, _, latents, text = tiny
    pipe = _pipeline(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _one_call(pipe, latents, text, 6)
    names = [e.name for e in prof.events()]
    dense = [n for n in names if n.startswith("rsa.dense")]
    cross = [n for n in names if n.startswith("rsa.cross")]
    assert dense == ["rsa.dense:b=1,h=2,q=1024,k=1024,d=32"] * 2
    assert cross == ["rsa.cross:b=1,h=2,q=1024,k=16,d=32"] * 3
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    _one_call(pipe, latents, text, 6)
    _one_call(pipe, latents, text, 0, sparse=False)
    assert entered == []
    q = torch.zeros(1, 2, 8, 4)
    assert timing.attention_span("rsa.cross", q, q) is timing._OFF


def test_unipc_matches_reference():
    """The port's UniPC (order 2, flow prediction, bh2) step by step
    against the reference's, which redoes each step from the step's flow
    prediction, its latents and the x0 predictions of the two steps
    before it (as the benchmark's check does), none of them the sampler's
    own state.  The port steps in fp32, the reference in float64: the
    rounding of latents of size ~1 reads up to ~4e-6 of an update of
    ~0.06 (the first step's); 3e-5 leaves room for it, and a wrong
    coefficient moves the update by O(h^2) ~ 1e-3 of it."""
    from rectified_spaattn_tpu_torch.pipelines import UniPCScheduler
    g = torch.Generator().manual_seed(11)
    sched = UniPCScheduler(10, shift=5.0)
    sigmas = common.flow_sigmas(10, 5.0)
    x = torch.randn(1, 4, 2, 8, 8, generator=g)
    x0_back = []
    for i in range(10):
        v = torch.randn(x.shape, generator=g)
        want = ref.unipc_update(sigmas, i, v, x, x0_back)
        out = sched.step(v, x, i)
        assert float((out.double() - want).abs().max()
                     / (want - x.double()).abs().max()) < 3e-5, i
        x0_back = [ref.unipc_x0(sigmas, i, v, x)] + x0_back[:1]
        x = out
