"""HunyuanVideo T2V through the port's normal path: the model built by its
constructor on the meta device with the benchmark's weights assigned,
``HunyuanVideoPipeline.denoise`` as the window's entry, and the
reference's step beside it."""

from __future__ import annotations

import json
import os

import torch

from rectified_spaattn_tpu_torch.models.hunyuan import (HunyuanVideoConfig,
                                                         HunyuanVideoDiT)
from rectified_spaattn_tpu_torch.pipelines import hunyuan as pipeline_module

from .. import check, inputs
from ..reference import hunyuan as ref

# where the denoise loop looks up its sampler (the window wraps it)
SCHEDULER = (pipeline_module, "FlowMatchEulerScheduler")


def model_config(c: dict) -> dict:
    """The reference's sizes from the configuration file's diffusers keys
    and site / sampler settings."""
    return dict(
        in_channels=c["in_channels"], out_channels=c["out_channels"],
        hidden_dim=c["num_attention_heads"] * c["attention_head_dim"],
        heads=c["num_attention_heads"], head_dim=c["attention_head_dim"],
        num_dual_blocks=c["num_layers"],
        num_single_blocks=c["num_single_layers"],
        num_refiner_blocks=c["num_refiner_layers"],
        mlp_mult=c["mlp_ratio"], patch_size=c["patch_size"],
        patch_size_t=c["patch_size_t"], text_dim=c["text_embed_dim"],
        pooled_dim=c["pooled_projection_dim"],
        rope_axes_dim=tuple(c["rope_axes_dim"]), rope_theta=c["rope_theta"],
        **c["site"], **c["sampler"])


def latent_shape(c: dict) -> tuple:
    v = c["video"]
    return (1, c["in_channels"], v["frames"] // 4, v["height"] // 8,
            v["width"] // 8)


def param_table(c: dict) -> list:
    return ref.param_table(model_config(c))


def make_inputs(c: dict, traffic: dict, seed: int, device) -> dict:
    text_len = c["site"]["text_len"]
    (text,) = inputs.text_embeddings(1, text_len, c["text_embed_dim"], seed,
                                     device)
    mask = torch.arange(text_len, device=device) < traffic["text_valid"]
    return {"latents": inputs.smooth_latents(latent_shape(c), seed, device),
            "text": text, "mask": mask}


def _schedule(traffic: dict, root: str):
    tc = traffic.get("teacache")
    if not tc:
        return None
    with open(os.path.join(root, tc["schedule"])) as f:
        return [bool(r["compute"]) for r in json.load(f) if "call" in r]


def build(c: dict, traffic: dict, weights: dict, device, root: str):
    m = model_config(c)
    cfg = HunyuanVideoConfig(**{k: m[k] for k in (
        "in_channels", "out_channels", "hidden_dim", "heads", "head_dim",
        "num_dual_blocks", "num_single_blocks", "num_refiner_blocks",
        "mlp_mult", "patch_size", "patch_size_t", "text_dim", "pooled_dim",
        "rope_axes_dim", "rope_theta")})
    with torch.device("meta"):
        model = HunyuanVideoDiT(cfg)
    model.load_state_dict(weights, strict=True, assign=True)
    v = c["video"]
    schedule = _schedule(traffic, root)
    return pipeline_module.HunyuanVideoPipeline(
        model, height=v["height"], width=v["width"], frames=v["frames"],
        num_steps=traffic["num_steps"], sa_drop_rate=m["sa_drop_rate"],
        p_remain_rates=m["p_remain"], mode=traffic["mode"],
        enable_teacache=schedule is not None,
        teacache_schedule=schedule, text_len=m["text_len"],
        guidance_scale=m["guidance_scale"], flow_shift=m["flow_shift"],
        group_rows=m["group_rows"], device=device)


def denoise(pipe, inp: dict):
    return pipe.denoise(inp["latents"], inp["text"][None], inp["mask"][None])


def computed_steps(traffic: dict, root: str, steps: int) -> list:
    """Per step: does it run the block stack (TeaCache's replayed
    schedule, one call a step)?"""
    sched = _schedule(traffic, root)
    return [True] * steps if sched is None else [
        sched[i] if i < len(sched) else True for i in range(steps)]


def reference(c: dict, traffic: dict, weights: dict, inp: dict, states: dict,
              computed: list, device, precision: str) -> dict:
    """The reference's own curve, its first block's plan on the first
    checked step it computes, and each checked step's update from the
    program's latents entering it.  ``states`` {step: latents in}; a
    skipped step reuses the residual of the step before it, which the
    reference computes itself (it is among ``states``)."""
    m = model_config(c)
    m["num_steps"] = traffic["num_steps"]
    model = ref.Model(m, weights, latent_shape(c), device, precision)
    tlen = int(traffic["text_valid"])
    out = {"c2l": model.site.c2l,
           "neighbors": model.site.neighbors.cpu().numpy(), "delta": {}}
    residual = None
    for i in sorted(states):
        lat = states[i].to(device)
        x, ctx, temb = model.embed(lat, i, inp["text"], inp["mask"])
        if computed[i]:
            masks = []
            x_out, _ = model.blocks(x, ctx, temb, tlen, masks)
            out.setdefault("mask", masks[0])
            # TeaCache keeps the stack's residual in bf16, its published
            # format (main_hunyuan.py:152 of the reference system)
            residual, x = (x_out - x).bfloat16().float(), x_out
        else:
            x = x + residual
        out["delta"][i] = model.step(lat, model.head(x, temb), i) - lat
    return out


def numbers(side: dict, ref_out: dict, checked: list, computed: list) -> dict:
    """The site's numbers and each checked step's update (the guidance is
    embedded: one call a step)."""
    out = check.site_numbers(side, ref_out)
    for i in checked:
        check.gaps(out, "step" if computed[i] else "skip", side["delta"][i],
                   ref_out["delta"][i])
    return out
