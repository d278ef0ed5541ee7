"""The full-scale fidelity gate: the rectified sparse site against the
windowed dense on the same inputs at one operating point (port of
scripts/fidelity_gate.py:33-116).

HunyuanVideo's point by default: 720p x 128 frames (latent grid (32, 45,
80): 115,200 visual + 256 text tokens), 24 heads x 128, drop 0.8,
p_remain 0.3, smooth inputs (the regime real checkpoints run in).
``--layout visual`` drops the text tail and keeps the first frame's
blocks, as Wan's site does.  The metrics run on the device over the
visual rows (the text rows are exact in both paths): rel-L1, PSNR,
cosine and RMSE of the sparse output against the dense one; the density
is the plan's mean count over the key blocks.

    python -m rectified_spaattn_tpu_torch.bench.fidelity_gate [--frames 128]
    python -m rectified_spaattn_tpu_torch.bench.fidelity_gate --device cpu \\
        --small

Prints ONE JSON line with the script's keys (unrounded).  ``--small`` (a
CPU rehearsal of the plain versions) runs the latent grid (8, 24, 32) at
4 heads; ``grid=`` / ``heads=`` of ``run`` set any other.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..attention import rectified_sparse_attention
from ..attention.modes import _windowed_dense_flash
from ..curves import cached_curve
from ..sparse import SparseConfig, build_sparse_plan, select_block_num
from .common import SMALL_GRID, device_info, resolve
from .inputs import smooth_qkv

HEAD_DIM = 128
SMALL_HEADS = 4


def point_site(grid, *, drop: float, p_remain: float, layout: str,
               text_len: int, device, **cfg_kw):
    """The scripts' site at ``grid``: SparseConfig (top-k floor from the
    drop rate, the first frame's blocks kept in the visual layout), the
    block neighbour mask and the curve's h2l, on ``device``."""
    lt, lh, lw = grid
    _, h2l, nbr = cached_curve(lt, lh, lw, block_size=128)
    img_blocks = lt * lh * lw // 128
    cfg = SparseConfig(
        top_k_floor=max(1, select_block_num(drop, img_blocks)),
        p_remain=p_remain, layout=layout, text_len=text_len,
        first_frame_blocks=(img_blocks // lt if layout == "visual" else 0),
        **cfg_kw)
    return (cfg, torch.as_tensor(nbr, device=device),
            torch.as_tensor(h2l, device=device))


def gate_outputs(q, k, v, cfg, nbr, *, visual_len: int, text_len: int):
    """(sparse, dense) outputs of the site on the same q / k / v."""
    b = q.shape[0]
    tlen = torch.full((b,), text_len, dtype=torch.int32, device=q.device)
    sp = rectified_sparse_attention(
        q, k, v, cfg, nbr, visual_len=visual_len,
        text_len_rt=tlen if text_len else None)
    dn = _windowed_dense_flash(
        q, k, v, visual_len=visual_len,
        text_start=visual_len if text_len else None, tlen=tlen)
    return sp, dn


def metrics(sp, dn, visual_len: int) -> dict:
    """rel-L1, PSNR (dB, over the dense output's range), cosine and RMSE
    of ``sp`` against ``dn`` over the visual rows, in fp32 on their
    device (fidelity_gate.py:84-100)."""
    sp = sp[:, :, :visual_len].float()
    dn = dn[:, :, :visual_len].float()
    diff = sp - dn
    rel_l1 = diff.abs().mean() / dn.abs().mean()
    mse = (diff * diff).mean()
    rng = dn.max() - dn.min()
    psnr = 10.0 * torch.log10(rng * rng / torch.clamp(mse, min=1e-30))
    cos = (sp * dn).sum() / torch.clamp(
        torch.linalg.vector_norm(sp) * torch.linalg.vector_norm(dn),
        min=1e-30)
    return {"rel_l1": float(rel_l1), "psnr_db": float(psnr),
            "cosine": float(cos), "rmse": float(torch.sqrt(mse))}


def plan_density(q, k, v, cfg, nbr, visual_len: int, n_blocks: int):
    """(counts, density): the plan's per-row key-block counts and their
    mean over ``n_blocks`` key blocks."""
    counts = build_sparse_plan(q[:, :, :visual_len], k, v, cfg,
                               neighbor_mask=nbr).counts
    return counts, float(counts.float().mean()) / n_blocks


def run(*, frames: int = 128, heads: int = 24, drop: float = 0.8,
        p_remain: float = 0.3, layout: str = "joint", small: bool = False,
        grid=None, device="cuda", seed: int = 0) -> dict:
    """The gate's line as a dict (module docstring)."""
    dev = resolve(device)
    if grid is None:
        grid = SMALL_GRID if small else (frames // 4, 45, 80)
    if small:
        heads = SMALL_HEADS
    lt, lh, lw = grid
    text_len = 256 if layout == "joint" else 0
    sv = lt * lh * lw
    s = sv + text_len
    cfg, nbr, h2l = point_site(grid, drop=drop, p_remain=p_remain,
                               layout=layout, text_len=text_len, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = smooth_qkv(gen, heads, text_len, HEAD_DIM, h2l, grid)
    _, density = plan_density(q, k, v, cfg, nbr, sv, s // 128)
    sp, dn = gate_outputs(q, k, v, cfg, nbr, visual_len=sv,
                          text_len=text_len)
    out = {"workload": (f"hunyuan720p_{frames}f" if layout == "joint"
                        else f"wan_{frames}f"),
           "tokens": s, "grid": list(grid), "heads": heads,
           "layout": layout, "sa_drop_rate": drop, "p_remain": p_remain,
           "density": density, **metrics(sp, dn, sv)}
    out.update(device_info(dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--drop", type=float, default=0.8)
    ap.add_argument("--p_remain", type=float, default=0.3)
    ap.add_argument("--layout", choices=("joint", "visual"), default="joint")
    ap.add_argument("--small", action="store_true",
                    help="the 8 x 24 x 32 latent grid at 4 heads (a CPU "
                         "rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
