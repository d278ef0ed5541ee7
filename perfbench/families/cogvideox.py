"""CogVideoX1.5 T2V through the port's normal path: the model built by its
constructor on the meta device with the benchmark's weights assigned,
``CogVideoXPipeline.denoise`` (two calls a step, dynamic CFG) as the
window's entry, and the reference's step beside it."""

from __future__ import annotations

import torch

from rectified_spaattn_tpu_torch.models.cogvideox import (CogVideoXConfig,
                                                           CogVideoXDiT)
from rectified_spaattn_tpu_torch.pipelines import cogvideox as pipeline_module

from .. import check, inputs
from ..reference import cogvideox as ref

# where the denoise loop looks up its sampler (the window wraps it) and
# the guidance it calls with each step's two transformer outputs
SCHEDULER = (pipeline_module, "CogVideoXDDIMScheduler")
OUTPUTS = ((pipeline_module, "classifier_free_guidance"),)


def model_config(c: dict) -> dict:
    """The reference's sizes from the configuration file's diffusers keys
    and site / sampler settings."""
    return dict(
        in_channels=c["in_channels"], out_channels=c["out_channels"],
        hidden_dim=c["num_attention_heads"] * c["attention_head_dim"],
        heads=c["num_attention_heads"], head_dim=c["attention_head_dim"],
        num_blocks=c["num_layers"], mlp_mult=c["mlp_ratio"],
        text_dim=c["text_embed_dim"], time_embed_dim=c["time_embed_dim"],
        patch_size=c["patch_size"], patch_size_t=c["patch_size_t"],
        rope_axes_dim=tuple(c["rope_axes_dim"]), rope_theta=c["rope_theta"],
        **c["site"], **c["sampler"])


def latent_frames(c: dict) -> int:
    """The source VAE's latent frames: time compressed by
    ``temporal_compression_ratio`` (81 frames: 21)."""
    return (c["video"]["frames"] - 1) // c["temporal_compression_ratio"] + 1


def latent_shape(c: dict) -> tuple:
    """The published latent grid: the latent frames padded to a multiple
    of ``patch_size_t`` as diffusers' CogVideoX1.5 pipeline pads them
    (81 frames: 22, so 11 x 48 x 85 = 44,880 visual tokens)."""
    v = c["video"]
    pt = c["patch_size_t"]
    t = (latent_frames(c) + pt - 1) // pt * pt
    return (1, c["in_channels"], t, v["height"] // 8, v["width"] // 8)


def port_frames(c: dict) -> int:
    """The ``frames`` argument for which the port's pipeline builds the
    published grid: it divides time by 8 ((frames - 1) // 8 + 1), where
    the source's VAE divides it by ``temporal_compression_ratio``."""
    return 8 * (latent_frames(c) - 1) + 1


def param_table(c: dict) -> list:
    return ref.param_table(model_config(c))


def make_inputs(c: dict, traffic: dict, seed: int, device) -> dict:
    cond, uncond = inputs.text_embeddings(2, traffic["text_valid"],
                                          c["text_embed_dim"], seed, device)
    return {"latents": inputs.smooth_latents(latent_shape(c), seed, device),
            "cond": cond, "uncond": uncond}


def build(c: dict, traffic: dict, weights: dict, device, root: str):
    m = model_config(c)
    cfg = CogVideoXConfig(**{k: m[k] for k in (
        "in_channels", "out_channels", "hidden_dim", "heads", "head_dim",
        "num_blocks", "mlp_mult", "text_dim", "time_embed_dim", "patch_size",
        "patch_size_t", "rope_axes_dim", "rope_theta")})
    with torch.device("meta"):
        model = CogVideoXDiT(cfg)
    model.load_state_dict(weights, strict=True, assign=True)
    v = c["video"]
    pipe = pipeline_module.CogVideoXPipeline(
        model, height=v["height"], width=v["width"], frames=port_frames(c),
        num_steps=traffic["num_steps"], sa_drop_rate=m["sa_drop_rate"],
        p_remain_rates=m["p_remain"], mode=traffic["mode"],
        text_len=m["text_len"], guidance_scale=m["guidance_scale"],
        sparse_warm_calls=m["sparse_warm_calls"],
        group_rows=m["group_rows"], device=device)
    if tuple(pipe.grid) != latent_shape(c)[2:]:
        raise ValueError(f"the port's grid {pipe.grid} is not the "
                         f"published {latent_shape(c)[2:]}")
    return pipe


def denoise(pipe, inp: dict):
    return pipe.denoise(inp["latents"], inp["cond"][None],
                        inp["uncond"][None])


def computed_steps(traffic: dict, root: str, steps: int) -> list:
    return [True] * steps


def reference(c: dict, traffic: dict, weights: dict, inp: dict, states: dict,
              computed: list, device, precision: str) -> dict:
    """The reference's own curve, its first block's plan on the first
    checked step (the cond call), and each checked step's update from the
    program's latents entering it."""
    m = model_config(c)
    m["num_steps"] = traffic["num_steps"]
    model = ref.Model(m, weights, latent_shape(c), device, precision)
    out = {"c2l": model.site.c2l,
           "neighbors": model.site.neighbors.cpu().numpy(), "calls": {},
           "model": model}
    for i in sorted(states):
        lat = states[i].to(device)
        masks = []
        v_cond = model.call(lat, i, inp["cond"], masks)
        out.setdefault("mask", masks[0])
        out["calls"][i] = (v_cond, model.call(lat, i, inp["uncond"], []))
    return out


def numbers(side: dict, ref_out: dict, checked: list, computed: list) -> dict:
    """The site's numbers, each checked step's two transformer outputs
    (cond, uncond), and (the program) its guidance and DDIM update redone
    from its own outputs, which has to agree bit for bit.  The update is
    not compared with the reference's: the dynamic guidance scale, keyed
    on the raw timestep, swings between 1 and 7 from step to step, and
    its difference of two near-equal outputs multiplies their rounding
    by up to that much."""
    out = check.site_numbers(side, ref_out)
    model = ref_out["model"]
    for i in checked:
        calls = (side["outputs"][i][:2] if "outputs" in side
                 else side["calls"][i])
        for got, want in zip(calls, ref_out["calls"][i]):
            check.gaps(out, "call", got, want)
        if "outputs" in side:
            cond, uncond, _ = side["outputs"][i]
            redo = model.update(side["ins"][i], cond, uncond, i)
            out["sched_mismatch"] = out.get("sched_mismatch", 0) + int(
                (redo != side["outs"][i]).sum())
    return out
