"""The card's data-sheet peaks and a call's roofline bound: a frozen copy
of chip_smoke.py:362-365 (``PEAK_*``) and :524-527 (``bound_ms``), with
the per-call operations and bytes of the attention kernels counted as
chip_smoke.py:1095-1101 counts them (kept (query block, key block) pairs,
each input byte read once)."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3
BLOCK = 128                   # query rows and keys per block


def bound_s(flops: float, nbytes: float,
            peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations over the peak rate
    or bytes over the memory bandwidth, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_HBM_BYTES)


def pair_flops(d: int, rows: int = BLOCK) -> float:
    """Both products of one (query block, key block) pair."""
    return 4.0 * rows * BLOCK * d


def attention_call(pairs_visual: float, used_blocks: float, *, b: int,
                   h: int, rows_visual: int, d: int, text_len: int,
                   key_blocks: int, elem: int = 2):
    """(flops, bound seconds) of one site call's kernels: the visual rows
    over their kept pairs (q and o read / written once, each used K / V
    block once), and the text rows over every key block."""
    kv = lambda blocks: 2 * blocks * BLOCK * d * elem
    qo = lambda rows: 2 * b * h * rows * d * elem
    fl_v = pairs_visual * pair_flops(d)
    pairs_t = b * h * (text_len // BLOCK) * key_blocks
    fl_t = pairs_t * pair_flops(d)
    bound = (bound_s(fl_v, qo(rows_visual) + kv(used_blocks))
             + bound_s(fl_t, qo(text_len) + kv(b * h * key_blocks)))
    return fl_v + fl_t, bound
