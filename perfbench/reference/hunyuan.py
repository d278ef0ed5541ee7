"""HunyuanVideo T2V, one denoise step, in plain float32 for the yardstick
(the architecture of diffusers' HunyuanVideoTransformer3DModel as the port
lays it out, models/hunyuan.py and models/layers.py, written again
without the port): the token refiner, the time / pooled / guidance
embeddings, the dual- and single-stream blocks with the rectified site in
curve order, the adaLN head, the flow-match Euler update.

Weights are read by the port's parameter names (``param_table``), which
is how the benchmark draws them: one table, both sides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common, curve, sparse


def param_table(c: dict) -> list:
    """[(name, shape)] of every weight, in the port's names and order."""
    hd, td, pd = c["hidden_dim"], c["text_dim"], c["pooled_dim"]
    mlp = int(hd * c["mlp_mult"])
    patch = c["patch_size_t"] * c["patch_size"] ** 2
    head = hd // c["heads"]
    t = []

    def lin(name, i, o):
        t.extend([(name + ".weight", (o, i)), (name + ".bias", (o,))])

    def ffn(name, d, hidden):
        lin(name + ".fc1", d, hidden)
        lin(name + ".fc2", hidden, d)

    lin("x_embedder", patch * c["in_channels"], hd)
    r = "context_embedder."
    lin(r + "time_in", 256, hd)
    ffn(r + "time_mlp", hd, hd)
    lin(r + "pool_in", td, hd)
    ffn(r + "pool_mlp", hd, hd)
    lin(r + "proj_in", td, hd)
    for i in range(c["num_refiner_blocks"]):
        b = f"{r}blk{i}_"
        lin(b + "ada", hd, 2 * hd)
        t.extend([(b + "norm1.weight", (hd,)), (b + "norm1.bias", (hd,))])
        lin(b + "qkv", hd, 3 * hd)
        lin(b + "proj", hd, hd)
        t.extend([(b + "norm2.weight", (hd,)), (b + "norm2.bias", (hd,))])
        ffn(b + "mlp", hd, mlp)
    lin("time_in", 256, hd)
    ffn("time_mlp", hd, hd)
    lin("pooled_in", pd, hd)
    ffn("pooled_mlp", hd, hd)
    lin("clip_pool_proj", td, pd)
    lin("guide_in", 256, hd)
    ffn("guide_mlp", hd, hd)
    for i in range(c["num_dual_blocks"]):
        b = f"dual_blocks.{i}."
        lin(b + "norm1.linear", hd, 6 * hd)
        lin(b + "norm1_context.linear", hd, 6 * hd)
        for n in ("to_q", "to_k", "to_v", "add_to_q", "add_to_k",
                  "add_to_v"):
            lin(b + "attn." + n, hd, hd)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            t.append((b + f"attn.{n}.weight", (head,)))
        lin(b + "attn.to_out", hd, hd)
        lin(b + "attn.to_add_out", hd, hd)
        ffn(b + "ff", hd, mlp)
        ffn(b + "ff_context", hd, mlp)
    for i in range(c["num_single_blocks"]):
        b = f"single_blocks.{i}."
        lin(b + "norm.linear", hd, 3 * hd)
        lin(b + "to_qkv", hd, 3 * hd)
        t.extend([(b + "norm_q.weight", (head,)),
                  (b + "norm_k.weight", (head,))])
        lin(b + "proj_mlp", hd, mlp)
        lin(b + "proj_out", hd + mlp, hd)
    lin("norm_out.linear", hd, 2 * hd)
    lin("proj_out", hd, patch * c["out_channels"])
    return t


def _heads(x, n):
    return x.reshape(x.shape[0], n, -1).transpose(0, 1)


def _merge(x):
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def _mods(nm, temb, name, n):
    return nm.linear(F.silu(temb), name).chunk(n, dim=-1)


def _refiner(nm, c, text, t, mask):
    r = "context_embedder."
    hd, heads = c["hidden_dim"], c["heads"]
    temb = nm.mlp(nm.linear(common.timestep_features(t, 256), r + "time_in"),
                  r + "time_mlp", "silu")
    w = mask.float()[:, None]
    pooled = (text * w).sum(dim=0, keepdim=True) / w.sum().clamp(min=1e-3)
    cond = temb + nm.mlp(nm.linear(pooled, r + "pool_in"), r + "pool_mlp",
                         "silu")
    x = nm.linear(text, r + "proj_in")
    for i in range(c["num_refiner_blocks"]):
        b = f"{r}blk{i}_"
        g_attn, g_mlp = _mods(nm, cond, b + "ada", 2)
        q, k, v = (_heads(u, heads) for u in nm.linear(
            nm.layer_norm(x, b + "norm1"), b + "qkv").chunk(3, dim=-1))
        ok = mask.to(torch.bool)
        attn = _merge(sparse.dense_attention(nm.operand(q), nm.operand(k),
                                             nm.operand(v), ok))
        x = x + g_attn * nm.linear(attn, b + "proj")
        x = x + g_mlp * nm.mlp(nm.layer_norm(x, b + "norm2"), b + "mlp")
    return x


class Site:
    """The curve, the neighbour mask and the site settings of one
    geometry, worked out by the reference."""

    def __init__(self, c: dict, grid, device):
        gt, gh, gw = grid
        self.l2c, self.c2l = curve.gilbert_mapping(gt, gh, gw)
        self.neighbors = torch.as_tensor(
            curve.block_neighbors(self.l2c, gt, gh, gw), device=device)
        self.visual_len = gt * gh * gw
        self.floor = int((1.0 - c["sa_drop_rate"])
                         * (self.visual_len // sparse.BLOCK))
        self.p_remain = c["p_remain"]
        self.text_len = c["text_len"]
        self.c2l_t = torch.as_tensor(self.c2l, device=device)
        self.l2c_t = torch.as_tensor(self.l2c, device=device)


def _attn(nm, site, q, k, v, tlen, masks):
    out, mask = sparse.rectified_attention(
        q, k, v, nm, visual_len=site.visual_len, text_len=site.text_len,
        tlen=tlen, neighbors=site.neighbors, p_remain=site.p_remain,
        floor=site.floor)
    masks.append(mask)
    return out


def blocks(nm, c, site, x, ctx, temb, cos, sin, tlen, masks):
    """The block stack on x [Sv, C] (curve order), ctx [St, C]."""
    heads = c["heads"]
    sv = x.shape[0]

    def qk_rope(u, name, visual):
        """RMS-normed heads [H, S, D], rotated where they are visual."""
        u = nm.rms_norm(u, name)
        return common.rope(u, cos, sin) if visual else u

    for i in range(c["num_dual_blocks"]):
        b = f"dual_blocks.{i}."
        sx, cx, gx, sx2, cx2, gx2 = _mods(nm, temb, b + "norm1.linear", 6)
        sc, cc, gc, sc2, cc2, gc2 = _mods(nm, temb, b + "norm1_context.linear",
                                          6)
        xn = nm.layer_norm(x) * (1 + cx) + sx
        cn = nm.layer_norm(ctx) * (1 + cc) + sc
        a = b + "attn."
        q = torch.cat([qk_rope(_heads(nm.linear(xn, a + "to_q"), heads),
                               a + "norm_q", True),
                       qk_rope(_heads(nm.linear(cn, a + "add_to_q"), heads),
                               a + "norm_added_q", False)], dim=1)
        k = torch.cat([qk_rope(_heads(nm.linear(xn, a + "to_k"), heads),
                               a + "norm_k", True),
                       qk_rope(_heads(nm.linear(cn, a + "add_to_k"), heads),
                               a + "norm_added_k", False)], dim=1)
        v = torch.cat([_heads(nm.linear(xn, a + "to_v"), heads),
                       _heads(nm.linear(cn, a + "add_to_v"), heads)], dim=1)
        o = _merge(_attn(nm, site, q, k, v, tlen, masks))
        del q, k, v
        x = x + gx * nm.linear(o[:sv], a + "to_out")
        ctx = ctx + gc * nm.linear(o[sv:], a + "to_add_out")
        x = x + gx2 * nm.mlp(nm.layer_norm(x) * (1 + cx2) + sx2, b + "ff")
        ctx = ctx + gc2 * nm.mlp(nm.layer_norm(ctx) * (1 + cc2) + sc2,
                                 b + "ff_context")
    for i in range(c["num_single_blocks"]):
        b = f"single_blocks.{i}."
        shift, scale, gate = _mods(nm, temb, b + "norm.linear", 3)
        fused = torch.cat([x, ctx], dim=0)
        normed = nm.layer_norm(fused) * (1 + scale) + shift
        q, k, v = (_heads(u, heads) for u in
                   nm.linear(normed, b + "to_qkv").chunk(3, dim=-1))
        q = torch.cat([qk_rope(q[:, :sv], b + "norm_q", True),
                       qk_rope(q[:, sv:], b + "norm_q", False)], dim=1)
        k = torch.cat([qk_rope(k[:, :sv], b + "norm_k", True),
                       qk_rope(k[:, sv:], b + "norm_k", False)], dim=1)
        o = _merge(_attn(nm, site, q, k, v, tlen, masks))
        del q, k, v
        mlp_h = F.gelu(nm.linear(normed, b + "proj_mlp"), approximate="tanh")
        fused = fused + gate * nm.linear(torch.cat([o, mlp_h], dim=-1),
                                         b + "proj_out")
        del mlp_h, o
        x, ctx = fused[:sv], fused[sv:]
    return x, ctx


class Model:
    """One HunyuanVideo step at the cell's geometry: ``embed``,
    ``blocks``, ``head`` and ``step`` (the Euler update), in float32 or,
    for the control, float8 products."""

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
        self.sigmas = common.flow_sigmas(c["num_steps"], c["flow_shift"])

    def embed(self, latents, i, text, mask):
        """(x [Sv, C] curve order, ctx, temb [1, C]) at step i."""
        c, nm = self.c, self.nm
        t = torch.tensor([self.sigmas[i] * 1000.0], dtype=torch.float32,
                         device=latents.device)
        x = nm.linear(common.patchify(latents.float(), c["patch_size_t"],
                                      c["patch_size"]), "x_embedder")
        ctx = _refiner(nm, c, text.float(), t, mask)
        w = mask.float()[:, None]
        pooled = nm.linear((text * w).sum(dim=0, keepdim=True)
                           / w.sum().clamp(min=1e-3), "clip_pool_proj")
        g = torch.full((1,), c["guidance_scale"] * 1000.0,
                       device=latents.device)
        temb = (nm.mlp(nm.linear(common.timestep_features(t, 256),
                                 "time_in"), "time_mlp", "silu")
                + nm.mlp(nm.linear(pooled, "pooled_in"), "pooled_mlp",
                         "silu")
                + nm.mlp(nm.linear(common.timestep_features(g, 256),
                                   "guide_in"), "guide_mlp", "silu"))
        return x[self.site.c2l_t], ctx, temb

    def blocks(self, x, ctx, temb, tlen, masks):
        return blocks(self.nm, self.c, self.site, x, ctx, temb, self.cos,
                      self.sin, tlen, masks)

    def head(self, x, temb):
        c, nm = self.c, self.nm
        shift, scale = _mods(nm, temb, "norm_out.linear", 2)
        x = nm.layer_norm(x[self.site.l2c_t]) * (1 + scale) + shift
        return common.unpatchify(nm.linear(x, "proj_out"), self.shape,
                                 c["patch_size_t"], c["patch_size"])

    def step(self, latents, v, i):
        return latents.float() + v * float(self.sigmas[i + 1]
                                           - self.sigmas[i])
