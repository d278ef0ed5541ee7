"""The plan's selection and compaction variants (port of
scripts/bench_planopts.py and scripts/bench_mask2idx.py).

Top-p with a top-k floor at [1, 24, 900, 901] (p_remain 0.3, floor 180)
on softmaxed normal scores, three ways:

  A  argsort, then the inverse argsort for each column's rank
     (bench_planopts.py:21-31; ``sparse/ops.py::topp_topk_counts`` +
     ``counts_to_onehot``);
  B  one value sort and a threshold at the count (:33-42; ties at the
     threshold are all kept, so B's mask may hold more than the count);
  C  argsort, the rank by a scatter of the order (:44-55);

then the index-compaction sort of A's mask (:58-62), and mask -> indices
at [1, 24, 900, 904], density 0.3 (bench_mask2idx.py:21-50): by a sort of
the column keys (``ops.mask_to_indices``), by a cumsum + scatter, and by
a sort of int16 keys (bench_planstages2.py:180-196).  The cumulative sums
are ``ops.cumsum_xla_order`` (jnp.cumsum's order: ``torch.cumsum`` moves
a sum that lands on p_remain).

    python -m rectified_spaattn_tpu_torch.bench.planopts [--reps 5]
    python -m rectified_spaattn_tpu_torch.bench.planopts --device cpu --small

Each variant is timed one-shot (each call waited for, the scripts'
``timed``) and over back-to-back calls between CUDA events.  Prints ONE
JSON line: the times, and the scripts' checks: A == C, the count of A / B
mask entries that differ (ties, by design), A's and B's counts equal,
sort == scatter (and == int16).  The probabilities come from a seeded
``torch.Generator`` on the device (the scripts' jax.random draw has no
torch counterpart); the mask2idx mask is the script's numpy draw, bit for
bit.  ``--small``: [1, 2, 60, 61] and [1, 2, 60, 64].
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..sparse.ops import cumsum_xla_order, mask_to_indices
from .common import device_info, oneshot_ms, resolve, time_ms

TOPP_SHAPE = (1, 24, 900, 901)
M2I_SHAPE = (1, 24, 900, 904)
SMALL_TOPP = (1, 2, 60, 61)
SMALL_M2I = (1, 2, 60, 64)
P_REMAIN, FLOOR = 0.3, 180


def _counts(sorted_desc, p_remain, floor):
    csum = cumsum_xla_order(sorted_desc)
    counts = (csum <= p_remain).sum(-1).to(torch.int32) + 1
    return torch.clamp(counts, min=floor)


def variant_a(probs, p_remain=P_REMAIN, floor=FLOOR):
    """Two argsorts (bench_planopts.py:21-31): (onehot, counts)."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    counts = _counts(torch.gather(probs, -1, order), p_remain, floor)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank < counts[..., None], counts


def variant_b(probs, p_remain=P_REMAIN, floor=FLOOR):
    """One value sort and a threshold (:33-42): (onehot, counts)."""
    sp = torch.flip(torch.sort(probs, dim=-1).values, dims=(-1,))
    counts = _counts(sp, p_remain, floor)
    thresh = torch.gather(sp, -1, (counts - 1)[..., None].long())
    return probs >= thresh, counts


def variant_c(probs, p_remain=P_REMAIN, floor=FLOOR):
    """Argsort and a scatter rank (:44-55): (onehot, counts)."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    counts = _counts(torch.gather(probs, -1, order), p_remain, floor)
    iota = torch.arange(order.shape[-1], device=probs.device).expand(
        order.shape)
    rank = torch.zeros_like(order).scatter(-1, order, iota)
    return rank < counts[..., None], counts


def index_sort(mask):
    """The index-compaction sort of a mask (:58-62): selected columns
    first, ascending."""
    nb = mask.shape[-1]
    col = torch.arange(nb, dtype=torch.int32, device=mask.device)
    return torch.sort(torch.where(mask, col, col + nb), dim=-1).values


def _pad_last(idx, counts):
    """Slots past the count repeat the last valid index."""
    nb = idx.shape[-1]
    last = torch.gather(idx, -1,
                        torch.clamp(counts - 1, min=0)[..., None].long())
    slot = torch.arange(nb, dtype=torch.int32, device=idx.device)
    return torch.where(slot < counts[..., None], idx, last)


def via_sort(mask):
    """mask -> (indices, counts) by a sort of column keys
    (bench_mask2idx.py:25-34)."""
    counts = mask.sum(-1).to(torch.int32)
    return _pad_last(index_sort(mask), counts), counts


def via_scatter(mask):
    """mask -> (indices, counts) by a cumsum rank and a scatter
    (bench_mask2idx.py:37-50).  Unselected columns all scatter into the
    last slot, which the padding overwrites unless every column is
    selected (then none scatters there twice)."""
    nb = mask.shape[-1]
    col = torch.arange(nb, dtype=torch.int32, device=mask.device).expand(
        mask.shape)
    counts = mask.sum(-1).to(torch.int32)
    rank = cumsum_xla_order(mask.to(torch.int32)) - 1
    target = torch.where(mask, rank, nb - 1).long()
    idx = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    return _pad_last(idx.scatter(-1, target, col), counts), counts


def via_int16(mask):
    """mask -> (indices, counts) by a sort of int16 keys
    (bench_planstages2.py:180-196; nb < 2^14)."""
    nb = mask.shape[-1]
    counts = mask.sum(-1).to(torch.int32)
    col = torch.arange(nb, dtype=torch.int16, device=mask.device)
    key16 = torch.where(mask, col, col + nb)
    idx = torch.sort(key16, dim=-1).values.to(torch.int32)
    return torch.clamp(_pad_last(idx, counts), max=nb - 1), counts


def m2i_mask(shape, density: float = 0.3, seed: int = 0) -> np.ndarray:
    """bench_mask2idx.py:21-22's mask: numpy uniforms below the density."""
    return np.random.default_rng(seed).uniform(size=shape) < density


def run(*, small: bool = False, reps: int = 5, k: int = 10, device="cuda",
        seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    shape = SMALL_TOPP if small else TOPP_SHAPE
    floor = max(1, shape[-1] // 5) if small else FLOOR
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    probs = torch.softmax(torch.randn(shape, generator=gen, device=dev), -1)
    mask = torch.from_numpy(m2i_mask(SMALL_M2I if small else M2I_SHAPE)
                            ).to(dev)

    def times(fn):
        return {"oneshot_ms": oneshot_ms(fn, dev, reps),
                "event_ms": time_ms(fn, dev, reps=k)}

    (oa, ca), (ob, cb), (oc, cc) = (f(probs, P_REMAIN, floor)
                                    for f in (variant_a, variant_b,
                                              variant_c))
    (i_s, c_s), (i_c, c_c), (i_16, c_16) = (f(mask) for f in (
        via_sort, via_scatter, via_int16))
    i_ops, c_ops = mask_to_indices(mask)
    line = {
        "topp": {
            "shape": list(shape), "p_remain": P_REMAIN, "floor": floor,
            "A_two_argsorts": times(lambda: variant_a(probs, P_REMAIN,
                                                      floor)),
            "B_sort_threshold": times(lambda: variant_b(probs, P_REMAIN,
                                                        floor)),
            "C_argsort_scatter_rank": times(lambda: variant_c(
                probs, P_REMAIN, floor)),
            "index_compaction_sort": times(lambda: index_sort(oa)),
            "a_equals_c": bool(torch.equal(oa, oc)),
            "a_b_mask_diff": int((oa != ob).sum()),
            "counts_equal": bool(torch.equal(ca, cb)),
            "a_c_counts_equal": bool(torch.equal(ca, cc)),
        },
        "mask2idx": {
            "shape": list(mask.shape), "density": float(mask.float().mean()),
            "sort": times(lambda: via_sort(mask)),
            "scatter": times(lambda: via_scatter(mask)),
            "int16_sort": times(lambda: via_int16(mask)),
            "sort_equals_scatter": bool(torch.equal(i_s, i_c)
                                        and torch.equal(c_s, c_c)),
            "sort_equals_int16": bool(torch.equal(i_s, i_16)
                                      and torch.equal(c_s, c_16)),
            "sort_equals_ops": bool(torch.equal(i_s, i_ops)
                                    and torch.equal(c_s, c_ops)),
        },
        **device_info(dev),
    }
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="one-shot calls a variant (the scripts' n)")
    ap.add_argument("--k", type=int, default=10,
                    help="back-to-back calls between CUDA events")
    ap.add_argument("--small", action="store_true",
                    help="[1, 2, 60, 61] / [1, 2, 60, 64] (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
