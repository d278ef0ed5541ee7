"""Wan2.1 T2V through the port's normal path: the model built by its
constructor on the meta device with the benchmark's weights assigned,
``WanPipeline.denoise`` (two calls a step, UniPC) as the window's entry,
and the reference's two calls beside it.

Two things the harness does not keep, the family keeps for the step the
check draws (drawn from the seed as the harness draws it, for a timed
and for a traced run, since a run does not say which it is until its
profiler starts):

  * K1's lists.  At ``group_rows`` 1 the site forms no K2 lists; K1
    takes the plan's own index lists, so the step's first plan has its
    lists and counts held to its own mask on the device as it is built,
    and the count of rows that disagree is read once the window closes;
  * the two steps before it: their latents and guided outputs, copied
    to host memory, from which the check works out the x0 predictions
    that UniPC's update at the checked step needs (``sched_max_gap``),
    without the sampler's own history."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rectified_spaattn_tpu_torch.attention import rectified
from rectified_spaattn_tpu_torch.models.wan import WanConfig, WanDiT
from rectified_spaattn_tpu_torch.pipelines import wan as pipeline_module

from .. import check, harness, inputs
from ..reference import wan as ref

# where the denoise loop looks up its sampler (the window wraps it) and
# the guidance it calls with each step's two transformer outputs
SCHEDULER = (pipeline_module, "UniPCScheduler")
OUTPUTS = ((pipeline_module, "classifier_free_guidance"),)


def model_config(c: dict) -> dict:
    """The reference's sizes from the configuration file's diffusers keys
    and site / sampler settings; the port implements one form of the
    norms, and the family refuses another."""
    if (c["qk_norm"] != "rms_norm_across_heads" or not c["cross_attn_norm"]
            or c["eps"] != 1e-6):
        raise ValueError("the port's Wan block norms q and k across heads, "
                         "norms the cross-attention's input, at eps 1e-6")
    return dict(
        in_channels=c["in_channels"], out_channels=c["out_channels"],
        hidden_dim=c["num_attention_heads"] * c["attention_head_dim"],
        heads=c["num_attention_heads"], head_dim=c["attention_head_dim"],
        num_blocks=c["num_layers"], ffn_dim=c["ffn_dim"],
        patch_size=tuple(c["patch_size"]), text_dim=c["text_dim"],
        freq_dim=c["freq_dim"], rope_axes_dim=tuple(c["rope_axes_dim"]),
        rope_theta=c["rope_theta"], text_len=c["text_len"], **c["site"],
        **c["sampler"])


def latent_shape(c: dict) -> tuple:
    """The published latent grid: the VAE divides time by 4 (81 frames:
    21) and space by 8 (720 x 1280: 90 x 160)."""
    v, (st, sh, sw) = c["video"], c["vae_stride"]
    return (1, c["in_channels"], (v["frames"] - 1) // st + 1,
            v["height"] // sh, v["width"] // sw)


def param_table(c: dict) -> list:
    return ref.param_table(model_config(c))


def make_inputs(c: dict, traffic: dict, seed: int, device) -> dict:
    """Smooth latents and two prompts of ``text_valid`` drawn rows in
    ``text_len`` slots, zeros after them, as the Wan pipeline pads
    umT5's output; the steps the check draws in a timed and in a traced
    run, and a place for what the family keeps of the window."""
    pad = c["text_len"] - traffic["text_valid"]
    cond, uncond = (F.pad(e, (0, 0, 0, pad)) for e in inputs.text_embeddings(
        2, traffic["text_valid"], c["text_dim"], seed, device))
    computed = computed_steps(traffic, None, traffic["num_steps"])
    timed, traced = (harness.checked_steps(traffic, computed, seed, t)[0]
                     for t in (False, True))
    return {"latents": inputs.smooth_latents(latent_shape(c), seed, device),
            "cond": cond, "uncond": uncond, "checked": (timed, traced),
            "kept": {"lists": {}, "sampler": {}}}


def build(c: dict, traffic: dict, weights: dict, device, root: str):
    m = model_config(c)
    _sampler_check(m["flow_shift"])
    cfg = WanConfig(**{k: m[k] for k in (
        "in_channels", "out_channels", "hidden_dim", "heads", "head_dim",
        "num_blocks", "ffn_dim", "patch_size", "text_dim", "freq_dim",
        "rope_axes_dim", "rope_theta")})
    with torch.device("meta"):
        model = WanDiT(cfg)
    model.load_state_dict(weights, strict=True, assign=True)
    v, (st, sh, sw) = c["video"], c["vae_stride"]
    pt, ph, pw = c["patch_size"]
    pipe = pipeline_module.WanPipeline(
        model, height=v["height"], width=v["width"], frames=v["frames"],
        num_steps=traffic["num_steps"], sa_drop_rate=m["sa_drop_rate"],
        p_remain_rates=m["p_remain"], mode=traffic["mode"],
        guidance_scale=m["guidance_scale"], flow_shift=m["flow_shift"],
        vae_stride=(st * pt, sh * ph, sw * pw),
        warm_layers=m["warm_layers"], warm_calls=m["warm_calls"],
        scheduler=m["scheduler"], group_rows=m["group_rows"], device=device)
    if tuple(pipe.grid) != latent_shape(c)[2:]:
        raise ValueError(f"the port's grid {pipe.grid} is not the "
                         f"published {latent_shape(c)[2:]}")
    if (pipe.site.cfg.first_frame_blocks > 0) != m["first_frame_retention"]:
        raise ValueError("the port's first-frame retention is not the "
                         "configuration's")
    return pipe


def _k1_list_faults(plan) -> torch.Tensor:
    """Rows of K1's index lists that are not their mask's kept blocks in
    ascending order (count, membership, order), 0-d on the device."""
    mask, idx, counts = plan.block_mask, plan.indices.long(), plan.counts
    nb = mask.shape[-1]
    slot = torch.arange(nb, device=mask.device)
    live = slot < counts[..., None]
    kept = torch.gather(mask, -1, idx.clamp(0, nb - 1))
    rising = torch.ones_like(live)
    rising[..., 1:] = idx[..., 1:] > idx[..., :-1]
    bad = ((counts.long() != mask.sum(dim=-1))
           | (live & ~(kept & rising & (idx >= 0) & (idx < nb))).any(-1))
    return bad.sum()


def _host(t):
    return t.detach().to("cpu", copy=True)


def _sampler_check(shift: float):
    """Refuse a port whose UniPC is not the published one: its first
    three steps (orders 1, then 2) on a small sample against the
    reference's."""
    sched = pipeline_module.UniPCScheduler(6, shift=shift)
    g = torch.Generator().manual_seed(0)
    x, x0s = torch.randn(4, 8, generator=g), []
    for i in range(3):
        v = torch.randn(x.shape, generator=g)
        want = ref.unipc_update(sched.sigmas, i, v, x, x0s)
        out = sched.step(v, x, i)
        gap = float((out.double() - want).abs().max()
                    / (want - x.double()).abs().max())
        if gap > 1e-4:
            raise ValueError(f"the port's UniPC step {i} departs from the "
                             f"published bh2 form by {gap:.3g}")
        x0s.insert(0, ref.unipc_x0(sched.sigmas, i, v, x))
        x = out


def denoise(pipe, inp: dict):
    timed, traced = inp["checked"]
    lists, sampler = inp["kept"]["lists"], inp["kept"]["sampler"]
    lists.clear()
    sampler.clear()

    def wanted(c):
        # under the profiler the run is a traced one: its draw alone
        return c == traced or not torch.autograd._profiler_enabled()

    plan_orig = rectified.build_sparse_plan
    sched_orig = pipeline_module.UniPCScheduler

    def build_sparse_plan(*a, **kw):
        plan = plan_orig(*a, **kw)
        i = len(pipe.step_seconds)          # the step being run
        if i in (timed, traced) and wanted(i) and i not in lists:
            lists[i] = _k1_list_faults(plan)
        return plan

    class Kept(sched_orig):
        def step(self, model_out, sample, i):
            if any(c - 2 <= i < c and wanted(c) for c in (timed, traced)):
                sampler[i] = (_host(sample), _host(model_out))
            return super().step(model_out, sample, i)

    rectified.build_sparse_plan = build_sparse_plan
    pipeline_module.UniPCScheduler = Kept
    try:
        return pipe.denoise(inp["latents"], inp["cond"][None],
                            inp["uncond"][None])
    finally:
        rectified.build_sparse_plan = plan_orig
        pipeline_module.UniPCScheduler = sched_orig
        for i, n in lists.items():
            lists[i] = int(n)


def computed_steps(traffic: dict, root: str, steps: int) -> list:
    return [True] * steps


def reference(c: dict, traffic: dict, weights: dict, inp: dict, states: dict,
              computed: list, device, precision: str) -> dict:
    """The reference's own curve, its first sparse plan on the first
    checked step (the cond call), and each checked step's two calls from
    the program's latents entering it."""
    m = model_config(c)
    m["num_steps"] = traffic["num_steps"]
    model = ref.Model(m, weights, latent_shape(c), device, precision)
    out = {"c2l": model.site.c2l, "sigmas": model.sigmas,
           "neighbors": model.site.neighbors.cpu().numpy(), "calls": {},
           "kept": inp["kept"]}
    for i in sorted(states):
        lat = states[i].to(device)
        masks = []
        v_cond = model.call(lat, i, inp["cond"], masks, 2 * i)
        out.setdefault("mask", masks[0])
        out["calls"][i] = (v_cond, model.call(lat, i, inp["uncond"], [],
                                              2 * i + 1))
    return out


def numbers(side: dict, ref_out: dict, checked: list, computed: list) -> dict:
    """The site's numbers, each checked step's two transformer outputs
    (cond, uncond) and, for the program, its guidance and UniPC update
    redone from its own two outputs, its latents entering the step and
    the x0 predictions of the two steps before, each from that step's
    latents and guided output (``sched_max_gap``: the largest gap over
    the update's largest element).  The program's lists: K2's where it
    groups rows (the harness keeps them), else K1's, held to their
    plan's mask in the window."""
    out = check.site_numbers(side, ref_out)
    program = "outputs" in side
    kept = ref_out["kept"]
    if program and "groups" not in side:
        plan_step = min(i for i in checked if computed[i])
        if plan_step in kept["lists"]:
            out["lists_mismatch"] = kept["lists"][plan_step]
    sigmas = ref_out["sigmas"]
    for i in checked:
        calls = side["outputs"][i][:2] if program else side["calls"][i]
        for got, want in zip(calls, ref_out["calls"][i]):
            check.gaps(out, "call", got, want)
        back = [kept["sampler"].get(j) for j in (i - 1, i - 2) if j >= 0]
        if program and None not in back:
            cond, uncond, scale = side["outputs"][i]
            dev = cond.device
            x0_back = [ref.unipc_x0(sigmas, i - 1 - k, vk.to(dev), x.to(dev))
                       for k, (x, vk) in enumerate(back)]
            sample, got = side["ins"][i], side["outs"][i]
            v = uncond + scale * (cond - uncond)
            redo = ref.unipc_update(sigmas, i, v, sample, x0_back)
            gap = float((got.double() - redo).abs().max()
                        / (redo - sample.double()).abs().max())
            out["sched_max_gap"] = max(out.get("sched_max_gap", gap), gap)
    return out
