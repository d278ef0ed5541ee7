"""Wan2.1 T2V, one denoise step's two transformer calls, in plain float32
for the yardstick (the architecture of diffusers' WanTransformer3DModel
as the port lays it out, models/wan.py and models/layers.py, written
again without the port): the patch, text and time embeddings, the blocks
(modulated self-attention with q / k RMS-normed over the full width and
rotated by the interleaved 3-D RoPE, the un-modulated cross-attention to
the text, the modulated FFN), the modulated head.  Self-attention is
dense over every valid key in the warm layers and calls, and elsewhere
the rectified site in the visual layout: pooled softmax over the visual
blocks, GAPR, top-p with a top-k floor, the neighbour blocks, first-frame
block retention, then the rectification.

Departures from the published model, each where the port departs too
(the reference follows the program it holds to account):

  * the time embedder is Linear (freq_dim -> hidden), Linear, SiLU,
    Linear: the port's ``time_in`` then an MLP whose first Linear a
    converted checkpoint sets to the identity (models/weights.py::
    folded_embedder).  With drawn weights it is a random Linear, so the
    reference applies it too;
  * the curve order: tokens run in Gilbert-curve order between the patch
    embedding and the head (a permutation: RoPE travels with its token,
    and every other operation is per token);
  * the sparse site in place of dense self-attention past the warm gate;
  * the 512 text slots are the drawn umT5 rows, then zeros, attended
    without a mask (as the published pipeline pads and attends them).

``unipc_update`` redoes one step of the sampler, UniPC multistep (order
2, data prediction, Zhao et al. 2023) for flow matching, in the "bh2"
form that Wan2.1's published sampler takes: B(h) = e^h - 1, the order-2
predictor's rho 0.5, the order-2 corrector's rho solved, the last step
at order 1.  It starts from the step's latents, its guided output and
the x0 predictions of the two steps before it, and keeps no state of
its own between steps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common, curve, sparse


def param_table(c: dict) -> list:
    """[(name, shape)] of every weight, in the port's names and order."""
    hd, ffn = c["hidden_dim"], c["ffn_dim"]
    pt, ph, pw = c["patch_size"]
    patch = pt * ph * pw
    t = []

    def lin(name, i, o):
        t.extend([(name + ".weight", (o, i)), (name + ".bias", (o,))])

    lin("patch_embedding", patch * c["in_channels"], hd)
    lin("text_embedder.fc1", c["text_dim"], hd)
    lin("text_embedder.fc2", hd, hd)
    lin("time_in", c["freq_dim"], hd)
    lin("time_embedder.fc1", hd, hd)
    lin("time_embedder.fc2", hd, hd)
    lin("time_proj", hd, 6 * hd)
    for i in range(c["num_blocks"]):
        b = f"blocks.{i}."
        t.append((b + "scale_shift_table", (1, 6, hd)))
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v", "to_out"):
                lin(f"{b}{a}_{n}", hd, hd)
            for n in ("norm_q", "norm_k"):
                t.append((f"{b}{a}_{n}.weight", (hd,)))
        t.extend([(b + "norm2.weight", (hd,)), (b + "norm2.bias", (hd,))])
        lin(b + "ffn.fc1", hd, ffn)
        lin(b + "ffn.fc2", ffn, hd)
    t.append(("scale_shift_table_out", (1, 2, hd)))
    lin("proj_out", hd, patch * c["out_channels"])
    return t


def _heads(x, n):
    return x.reshape(x.shape[0], n, -1).transpose(0, 1)


def _merge(x):
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def dense_attention(q, k, v, rows: int = 4096):
    """Softmax attention [H, Sq, D] over every key of k, v [H, Sk, D],
    a head and ``rows`` queries at a time, so that the scores fit."""
    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5
    for i in range(q.shape[0]):
        for r0 in range(0, q.shape[1], rows):
            sc = q[i, r0:r0 + rows] @ k[i].t() * scale
            out[i, r0:r0 + rows] = torch.softmax(sc, dim=-1) @ v[i]
    return out


def visual_plan(q, k, v, *, neighbors, p_remain: float, floor: int,
                retained: int):
    """The block plan of one call in the visual layout.  q, k, v [H,
    NQ*128, D], zero past the valid tokens.  Returns (mask [H, NQ, NQ]
    bool, r [H, NQ], comp [H, NQ, D])."""
    h, s, d = q.shape
    nq = s // sparse.BLOCK
    qb, kb, vb = (x.reshape(h, nq, sparse.BLOCK, d) for x in (q, k, v))
    q_pool, k_pool = qb.mean(dim=2), kb.mean(dim=2)
    raw = torch.einsum("hqd,hkd->hqk", q_pool, k_pool)
    probs = torch.softmax(raw * d ** -0.5, dim=-1)
    # GAPR: the pooled estimate of a pair is trusted where its gain beats
    # the pooling error of either side
    dq = (qb - q_pool[:, :, None]).abs().mean(dim=2)
    dk = (kb - k_pool[:, :, None]).abs().mean(dim=2)
    n2 = sparse.BLOCK * sparse.BLOCK
    err = (torch.einsum("hqd,hkd->hqk", dq, k_pool).abs()
           + torch.einsum("hqd,hkd->hqk", q_pool, dk).abs()) * n2
    untrusted = ~(n2 * raw.abs() > err)
    # first-frame retention: the first ``retained`` curve blocks keep
    # each other
    blk = torch.arange(nq, device=q.device)
    first = (blk[:, None] < retained) & (blk[None, :] < retained)
    keep = (sparse._topp(probs, p_remain, floor) | neighbors[:nq, :nq]
            | first)
    partial = keep | untrusted
    r = torch.where(partial, probs, 0.0).sum(dim=-1)
    comp = torch.einsum("hqk,hkd->hqd", torch.where(partial, 0.0, probs),
                        vb.mean(dim=2))
    return keep, r, comp


def rectified_attention(q, k, v, numerics, *, neighbors, p_remain: float,
                        floor: int, retained: int, rows_per_step: int = 64):
    """The site on one call.  q, k, v [H, Sv, D] float32, the valid visual
    tokens in curve order.  Returns (out [H, Sv, D], mask [H, NQ, NQ])."""
    h, sv, d = q.shape
    pad = (-sv) % sparse.BLOCK
    q, k, v = (F.pad(numerics.operand(x), (0, 0, 0, pad))
               for x in (q, k, v))
    mask, r, comp = visual_plan(q, k, v, neighbors=neighbors,
                                p_remain=p_remain, floor=floor,
                                retained=retained)
    key_ok = torch.arange(sv + pad, device=q.device) < sv
    out = sparse._block_attention(q, k, v, mask, key_ok, rows_per_step)
    nq = (sv + pad) // sparse.BLOCK
    out = (out.reshape(h, nq, sparse.BLOCK, d) * r[..., None, None]
           + comp[:, :, None]).reshape(h, nq * sparse.BLOCK, d)
    return out[:, :sv], mask


class Site:
    """The curve, the neighbour mask and the site settings of one
    geometry, worked out by the reference."""

    def __init__(self, c: dict, grid, device):
        gt, gh, gw = grid
        self.l2c, self.c2l = curve.gilbert_mapping(gt, gh, gw)
        self.neighbors = torch.as_tensor(
            curve.block_neighbors(self.l2c, gt, gh, gw), device=device)
        self.visual_len = gt * gh * gw
        blocks = self.visual_len // sparse.BLOCK
        self.floor = int((1.0 - c["sa_drop_rate"]) * blocks)
        self.retained = blocks // gt if c["first_frame_retention"] else 0
        self.p_remain = c["p_remain"]
        self.c2l_t = torch.as_tensor(self.c2l, device=device)
        self.l2c_t = torch.as_tensor(self.l2c, device=device)


class Model:
    """One Wan2.1 step's transformer calls at the cell's geometry, in
    float32 or, for the control, float8 products."""

    def __init__(self, c: dict, weights: dict, latent_shape, device,
                 precision="fp32"):
        self.c, self.nm = c, common.Numerics(weights, precision)
        self.shape = latent_shape
        _, _, t, hh, ww = latent_shape
        pt, ph, pw = c["patch_size"]
        if ph != pw:
            raise ValueError("the patch must be square in space")
        self.grid = (t // pt, hh // ph, ww // pw)
        self.site = Site(c, self.grid, device)
        cos, sin = common.rope_tables(self.grid, c["rope_axes_dim"],
                                      c["rope_theta"], device)
        self.cos, self.sin = cos[self.site.c2l_t], sin[self.site.c2l_t]
        self.sigmas = common.flow_sigmas(c["num_steps"], c["flow_shift"])

    def self_attention(self, q, k, v, sparse_now: bool, masks):
        if not sparse_now:
            nm = self.nm
            return dense_attention(nm.operand(q), nm.operand(k),
                                   nm.operand(v))
        s = self.site
        out, mask = rectified_attention(
            q, k, v, self.nm, neighbors=s.neighbors, p_remain=s.p_remain,
            floor=s.floor, retained=s.retained)
        masks.append(mask)
        return out

    def embed(self, latents, i: int, text):
        """(x [Sv, C] in curve order, ctx [slots, C], temb [1, C], temb6
        [6, C]) at step i."""
        c, nm = self.c, self.nm
        t = torch.tensor([self.sigmas[i] * 1000.0], dtype=torch.float32,
                         device=latents.device)
        x = nm.linear(common.patchify(latents.float(), c["patch_size"][0],
                                      c["patch_size"][1]), "patch_embedding")
        ctx = nm.linear(F.gelu(nm.linear(text.float(), "text_embedder.fc1"),
                               approximate="tanh"), "text_embedder.fc2")
        temb = nm.mlp(nm.linear(common.timestep_features(t, c["freq_dim"]),
                                "time_in"), "time_embedder", "silu")
        temb6 = nm.linear(F.silu(temb), "time_proj").reshape(6, -1)
        return x[self.site.c2l_t], ctx, temb, temb6

    def block(self, k: int, x, ctx, temb6, sparse_now: bool, masks):
        """Block k on x [Sv, C] (curve order), ctx [slots, C]."""
        nm, heads = self.nm, self.c["heads"]
        b = f"blocks.{k}."
        m = nm.w[b + "scale_shift_table"].float()[0] + temb6
        shift, scale, gate, shift2, scale2, gate2 = m.unbind(0)
        xn = nm.layer_norm(x) * (1 + scale) + shift
        q, k_ = (common.rope(_heads(nm.rms_norm(
            nm.linear(xn, f"{b}attn1_to_{n}"), f"{b}attn1_norm_{n}"), heads),
            self.cos, self.sin) for n in ("q", "k"))
        v = _heads(nm.linear(xn, b + "attn1_to_v"), heads)
        del xn
        o = _merge(self.self_attention(q, k_, v, sparse_now, masks))
        del q, k_, v
        x = x + gate * nm.linear(o, b + "attn1_to_out")
        xc = nm.layer_norm(x, b + "norm2")
        q = _heads(nm.rms_norm(nm.linear(xc, b + "attn2_to_q"),
                               b + "attn2_norm_q"), heads)
        k_ = _heads(nm.rms_norm(nm.linear(ctx, b + "attn2_to_k"),
                                b + "attn2_norm_k"), heads)
        v = _heads(nm.linear(ctx, b + "attn2_to_v"), heads)
        del xc
        o = _merge(dense_attention(nm.operand(q), nm.operand(k_),
                                   nm.operand(v)))
        del q, k_, v
        x = x + nm.linear(o, b + "attn2_to_out")
        del o
        return x + gate2 * nm.mlp(nm.layer_norm(x) * (1 + scale2) + shift2,
                                  b + "ffn")

    def head(self, x, temb):
        c, nm = self.c, self.nm
        shift, scale = (nm.w["scale_shift_table_out"].float()[0]
                        + temb).unbind(0)
        x = nm.layer_norm(x[self.site.l2c_t]) * (1 + scale) + shift
        return common.unpatchify(nm.linear(x, "proj_out"), self.shape,
                                 c["patch_size"][0], c["patch_size"][1])

    def call(self, latents, i: int, text, masks, call_index=None):
        """The transformer on one stream at step i: v [1, C, T, H, W].
        ``text`` [slots, text_dim] (drawn rows, then zeros);
        ``call_index`` (default: past the warm calls) decides the warm
        gate with the block's index: dense in the warm calls and layers,
        the site elsewhere."""
        c = self.c
        warm_call = call_index is not None and call_index < c["warm_calls"]
        x, ctx, temb, temb6 = self.embed(latents, i, text)
        for k in range(c["num_blocks"]):
            sparse_now = not warm_call and k >= c["warm_layers"]
            x = self.block(k, x, ctx, temb6, sparse_now, masks)
        return self.head(x, temb)


def _lam(sigma: float) -> float:
    """log(alpha / sigma) of flow matching (alpha = 1 - sigma)."""
    return math.log(max(1.0 - sigma, 1e-12)) - math.log(max(sigma, 1e-12))


def _coeffs(hh: float) -> tuple:
    """(h phi_1, B(h), b1, b2) of UniPC's data-prediction branch at
    hh = -h: bh2's B(h) = e^hh - 1, and b1, b2 the right-hand side of the
    order-2 corrector's system."""
    phi1 = math.expm1(hh)
    phi2 = phi1 / hh - 1.0
    phi3 = phi2 / hh - 0.5
    return phi1, phi1, phi2 / phi1, 2.0 * phi3 / phi1


def unipc_x0(sigmas, i: int, v, sample):
    """Step i's data prediction in float64: x0 = x - sigma_i v."""
    return sample.double() - float(sigmas[i]) * v.double()


def unipc_update(sigmas, i: int, v, sample, x0_back):
    """The UniPC step from sigmas[i] to sigmas[i + 1] in float64.  ``v``
    the guided flow prediction, ``sample`` the latents entering the step;
    ``x0_back`` the x0 predictions of steps i - 1 and i - 2, as far as
    they exist.  The corrector refines the previous step's corrected
    sample, which is ``sample`` with that step's predictor term taken
    out, so the step needs nothing of the sampler's own state."""
    n = len(sigmas) - 1
    x, x0 = sample.double(), unipc_x0(sigmas, i, v, sample)
    if i >= 1:
        s0, st = float(sigmas[i - 1]), float(sigmas[i])
        h = _lam(st) - _lam(s0)
        _, bh, b1, b2 = _coeffs(-h)
        m1 = x0_back[0].double()
        if i >= 2:
            # order 2: out with the previous predictor's 0.5 * d1, in
            # with the corrector's rho1 * d1 + rho2 * (x0 - m1)
            rk = (_lam(float(sigmas[i - 2])) - _lam(s0)) / h
            d1 = (x0_back[1].double() - m1) / rk
            rho1 = (b1 - b2) / (1.0 - rk)
            corr = (rho1 - 0.5) * d1 + (b1 - rho1) * (x0 - m1)
        else:
            corr = 0.5 * (x0 - m1)
        x = x - (1.0 - st) * bh * corr
    s0, st = float(sigmas[i]), float(sigmas[i + 1])
    h = _lam(st) - _lam(s0)
    phi1, bh, _, _ = _coeffs(-h)
    out = (st / s0) * x - (1.0 - st) * phi1 * x0
    if 1 <= i < n - 1:
        rk = (_lam(float(sigmas[i - 1])) - _lam(s0)) / h
        out = out - (1.0 - st) * bh * 0.5 * (x0_back[0].double() - x0) / rk
    return out
