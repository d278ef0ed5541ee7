"""CogVideoX1.5-5B T2V, one denoise step, in plain float32 for the
yardstick (the architecture of diffusers' CogVideoXTransformer3DModel as
the port lays it out, models/cogvideox.py, written again without the
port): patch and text embedding, the time and ofs embeddings, the blocks
(LayerNormZero of both streams, shared q / k / v over [visual ; text],
per-head LayerNorm, RoPE on the visual slice, the rectified site), the
modulated head, dynamic CFG and the v-prediction DDIM update.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common
from .hunyuan import Site, _attn, _heads, _merge


def param_table(c: dict) -> list:
    """[(name, shape)] of every weight, in the port's names and order."""
    hd, te = c["hidden_dim"], c["time_embed_dim"]
    mlp = int(hd * c["mlp_mult"])
    patch = c["patch_size_t"] * c["patch_size"] ** 2
    head = hd // c["heads"]
    t = []

    def lin(name, i, o):
        t.extend([(name + ".weight", (o, i)), (name + ".bias", (o,))])

    def norm(name, d):
        t.extend([(name + ".weight", (d,)), (name + ".bias", (d,))])

    lin("patch_embed", patch * c["in_channels"], hd)
    lin("text_proj", c["text_dim"], hd)
    lin("time_in", te, te)
    lin("time_mlp.fc1", te, te)
    lin("time_mlp.fc2", te, te)
    lin("ofs_in", te, te)
    lin("ofs_mlp.fc1", te, te)
    lin("ofs_mlp.fc2", te, te)
    for i in range(c["num_blocks"]):
        b = f"blocks.{i}."
        for n in ("norm1", "norm2"):
            lin(b + n + "_lin", te, 6 * hd)
            norm(b + n + "_ln", hd)
        for n in ("to_q", "to_k", "to_v", "to_out"):
            lin(b + n, hd, hd)
        norm(b + "norm_q", head)
        norm(b + "norm_k", head)
        lin(b + "ff.fc1", hd, mlp)
        lin(b + "ff.fc2", mlp, hd)
    norm("norm_final", hd)
    lin("norm_out_lin", te, 2 * hd)
    norm("norm_out_ln", hd)
    lin("proj_out", hd, patch * c["out_channels"])
    return t


def dynamic_cfg(scale: float, t: float, steps: int) -> float:
    """CogVideoX's guidance scale, keyed on the raw timestep t."""
    return 1.0 + scale * ((1.0 - math.cos(
        math.pi * ((steps - t) / steps) ** 5.0)) / 2.0)


class Model:
    """One CogVideoX step (two calls, cond and uncond) at the cell's
    geometry, in float32 or, for the control, float8 products."""

    def __init__(self, c: dict, weights: dict, latent_shape, device,
                 precision="fp32"):
        self.c, self.nm = c, common.Numerics(weights, precision)
        self.shape = latent_shape
        _, _, t, hh, ww = latent_shape
        p = c["patch_size"]
        self.grid = (t // c["patch_size_t"], hh // p, ww // p)
        self.site = Site(c, self.grid, device)
        cos, sin = common.rope_tables(self.grid, c["rope_axes_dim"],
                                      c["rope_theta"], device)
        self.cos, self.sin = cos[self.site.c2l_t], sin[self.site.c2l_t]
        self.alphas = common.ddim_alphas()
        self.timesteps = common.ddim_timesteps(c["num_steps"])

    def call(self, latents, i, text, masks):
        """The transformer on one stream: v [1, C, T, H, W]."""
        c, nm, site = self.c, self.nm, self.site
        te, heads = c["time_embed_dim"], c["heads"]
        dev = latents.device
        t = torch.tensor([float(self.timesteps[i])], device=dev)
        x = nm.linear(common.patchify(latents.float(), c["patch_size_t"],
                                      c["patch_size"]), "patch_embed")
        x = x[site.c2l_t]
        slot = F.pad(text.float(), (0, 0, 0, site.text_len - text.shape[0]))
        ctx = nm.linear(slot, "text_proj")
        temb = (nm.mlp(nm.linear(common.timestep_features(t, te), "time_in"),
                       "time_mlp", "silu")
                + nm.mlp(nm.linear(common.timestep_features(
                    torch.zeros(1, device=dev), te), "ofs_in"), "ofs_mlp",
                    "silu"))
        sv = x.shape[0]
        tlen = min(226, site.text_len)
        for k in range(c["num_blocks"]):
            b = f"blocks.{k}."

            def zero_norm(n):
                sh, sc, g, shc, scc, gc = nm.linear(
                    F.silu(temb), b + n + "_lin").chunk(6, dim=-1)
                return (nm.layer_norm(x, b + n + "_ln", 1e-5) * (1 + sc) + sh,
                        nm.layer_norm(ctx, b + n + "_ln", 1e-5) * (1 + scc)
                        + shc, g, gc)

            xn, cn, gx, gc = zero_norm("norm1")
            fused = torch.cat([xn, cn], dim=0)
            q, k_, v = (_heads(nm.linear(fused, b + n), heads)
                        for n in ("to_q", "to_k", "to_v"))
            q = nm.layer_norm(q, b + "norm_q")
            k_ = nm.layer_norm(k_, b + "norm_k")
            q = torch.cat([common.rope(q[:, :sv], self.cos, self.sin),
                           q[:, sv:]], dim=1)
            k_ = torch.cat([common.rope(k_[:, :sv], self.cos, self.sin),
                            k_[:, sv:]], dim=1)
            o = nm.linear(_merge(_attn(nm, site, q, k_, v, tlen, masks)),
                          b + "to_out")
            del q, k_, v
            x = x + gx * o[:sv]
            ctx = ctx + gc * o[sv:]
            xn, cn, gx2, gc2 = zero_norm("norm2")
            x = x + gx2 * nm.mlp(xn, b + "ff")
            ctx = ctx + gc2 * nm.mlp(cn, b + "ff")
        x = nm.layer_norm(x[site.l2c_t], "norm_final", 1e-5)
        shift, scale = nm.linear(F.silu(temb), "norm_out_lin").chunk(2, -1)
        x = nm.layer_norm(x, "norm_out_ln", 1e-5) * (1 + scale) + shift
        return common.unpatchify(nm.linear(x, "proj_out"), self.shape,
                                 c["patch_size_t"], c["patch_size"])

    def update(self, latents, v_cond, v_uncond, i):
        """Dynamic CFG in the outputs' own type, then the v-prediction DDIM
        update from step i in float32 (the published sampler, with its
        scalars in float64)."""
        c = self.c
        t = int(self.timesteps[i])
        g = dynamic_cfg(c["guidance_scale"], float(t), c["num_steps"])
        v = (v_uncond + g * (v_cond - v_uncond)).float()
        prev = t - 1000 // c["num_steps"]
        a = self.alphas[t]
        a_prev = self.alphas[prev] if prev >= 0 else 1.0
        x = latents.float()
        x0 = float(a ** 0.5) * x - float((1 - a) ** 0.5) * v
        eps = float(a ** 0.5) * v + float((1 - a) ** 0.5) * x
        return float(a_prev ** 0.5) * x0 + float((1 - a_prev) ** 0.5) * eps
