"""The numbers that decide ``correct``: what the window's timed path
produced, held to the plain reference (each family picks its numbers,
perfbench/families/).

  curve_mismatch      positions of the curve order and entries of the
                      block neighbour mask where the program's differ from
                      the reference's Gilbert walk (exact: limit 0)
  lists_mismatch      row groups whose K2 index lists, counts, membership
                      bits or clean prefix disagree with the program's own
                      block mask (exact: limit 0)
  plan_mask_mismatch  kept (query block, visual key block) pairs of the
                      first block's plan in which the program's mask and
                      the reference's differ, over the reference's kept
                      pairs (each side from its own q and K)
  step_rel_l2         ||d_prog - d_ref|| / ||d_ref|| of a checked computed
                      step's latent update d (latents out - latents in,
                      from the program's latents in)
  step_max_gap        max |d_prog - d_ref| / max |d_ref| of that update
  skip_rel_l2 / skip_max_gap   the same of a checked step that TeaCache
                      skipped (the reference applies its own residual)
  call_rel_l2 / call_max_gap   the same of each transformer output of a
                      checked step that makes two calls (CFG), the larger
  sched_mismatch      elements of that step's update that differ from the
                      guidance and sampler redone from the program's own
                      two outputs (exact: limit 0)
"""

from __future__ import annotations

import numpy as np
import torch


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-300))


def curve_mismatch(prog: dict, ref: dict) -> int:
    bad = int((np.asarray(prog["c2l"]) != ref["c2l"]).sum())
    pn, rn = np.asarray(prog["neighbors"]), ref["neighbors"]
    if pn.shape != rn.shape:
        return bad + max(pn.size, rn.size)
    return bad + int((pn != rn).sum())


def plan_mask_mismatch(prog_mask: torch.Tensor, ref_mask: torch.Tensor
                       ) -> float:
    nq = ref_mask.shape[-2]
    p = prog_mask.reshape(ref_mask.shape)[..., :nq].to(ref_mask.device)
    r = ref_mask[..., :nq]
    return float((p ^ r).sum()) / max(float(r.sum()), 1.0)


def lists_mismatch(mask: torch.Tensor, groups) -> int:
    """Row groups of ``mask`` [B, H, NQ, NB] whose K2 lists (indices,
    counts, rowbits, clean) are not: the union of the group's kept blocks,
    those that every row keeps inside the clean window first, each part
    ascending; bit r of a slot's rowbits set where row r keeps its block."""
    (idx, counts, rowbits, clean), g, clean_blocks = groups
    b, h, nq, nb = mask.shape
    m = torch.nn.functional.pad(mask, (0, 0, 0, (-nq) % g))
    mg = m.reshape(b, h, -1, g, nb)
    union, every = mg.any(dim=3), mg.all(dim=3)
    col = torch.arange(nb, device=mask.device)
    is_clean = union & every & (col < clean_blocks)
    key = torch.where(is_clean, col, torch.where(union, col + nb,
                                                  col + 3 * nb))
    want_idx = torch.sort(key, dim=-1).values % nb
    want_counts = union.sum(dim=-1)
    slot_ok = col < want_counts[..., None]
    bits = sum((torch.gather(mg[:, :, :, r], -1, want_idx).long() << r)
               for r in range(g))
    bad = ((counts.long() != want_counts)
           | (clean.long() != is_clean.sum(dim=-1))
           | ((idx.long() != want_idx) & slot_ok).any(dim=-1)
           | ((rowbits.long() != bits) & slot_ok).any(dim=-1))
    return int(bad.sum())


def site_numbers(side: dict, ref: dict) -> dict:
    """The curve and plan numbers of one side (the program, or the control
    in its place) against the reference: its curve, first-block plan mask
    and (the program only) K2 lists."""
    out = {"curve_mismatch": curve_mismatch(side, ref)}
    if "groups" in side:
        out["lists_mismatch"] = lists_mismatch(side["mask"], side["groups"])
    out["plan_mask_mismatch"] = plan_mask_mismatch(side["mask"], ref["mask"])
    return out


def gaps(out: dict, kind: str, got: torch.Tensor, want: torch.Tensor):
    """``<kind>_rel_l2`` and ``<kind>_max_gap`` of got against want, the
    largest over the calls of ``kind`` so far."""
    got = got.to(want.device)
    for name, value in ((f"{kind}_rel_l2", rel_l2(got, want)),
                        (f"{kind}_max_gap", max_gap(got, want))):
        out[name] = max(out.get(name, value), value)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    without a limit, or a limit without its number, fails."""
    names = sorted(set(values) | set(limits))
    table = {n: {"value": values.get(n), "limit": limits.get(n)}
             for n in names}
    ok = all(v["value"] is not None and v["limit"] is not None
             and v["value"] <= v["limit"] for v in table.values())
    return ok, table
