"""The dense baselines at HunyuanVideo's token count (port of
scripts/bench_dense.py): the dense flash kernel K3
(``dense_attention(mode="flash")``) against the windowed dense, K1 with
full index lists (``attention/modes.py::_windowed_dense_flash``) at mask
row heights ``block_m`` 256, 512 and 1024 (q padded to the row height
independently of K and V), on one q = k = v draw of [1, 24, 115,456, 128]
bf16 (the script draws q, k and v from one key: the same tensor), every
key valid.

    python -m rectified_spaattn_tpu_torch.bench.dense [--iters 3]
    python -m rectified_spaattn_tpu_torch.bench.dense --device cpu --small

Each line: one-shot ms, each call waited for, over ``--iters`` calls
after one warm-up (the script's ``timed``), and TF/s at the forward's
4 B H S^2 D operations.  A ``block_m`` the kernel refuses is reported as
failed with the exception's name, as the script does, not skipped.
Beside them, as the yardstick (not the port), PyTorch's
``scaled_dot_product_attention`` on the same inputs.  Prints ONE JSON
line; ``--small``: 2,048 tokens at 4 heads.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..attention.modes import _windowed_dense_flash
from ..kernels import dense_attention
from .common import device_info, oneshot_ms, resolve
from .fidelity_gate import SMALL_HEADS

TOKENS = 115_456          # 115,200 visual + 256 text
SMALL_TOKENS = 2_048
BLOCK_MS = (256, 512, 1024)


def run(*, iters: int = 3, heads: int = 24, small: bool = False,
        tokens=None, device="cuda", seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    if small:
        heads = SMALL_HEADS
    s = tokens or (SMALL_TOKENS if small else TOKENS)
    b, d = 1, 128
    flops = 4 * b * heads * s * s * d
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, heads, s, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k = v = q
    tlen = torch.zeros((b,), dtype=torch.int32, device=dev)

    def line(fn):
        ms = oneshot_ms(fn, dev, iters)
        return {"ms": ms, "tflops": flops / ms / 1e9}

    res = {"stock_flash_k3": line(lambda: dense_attention(q, k, v,
                                                          mode="flash"))}
    for bm in BLOCK_MS:
        try:
            res[f"windowed_bm{bm}"] = line(lambda bm=bm: _windowed_dense_flash(
                q, k, v, visual_len=s, text_start=None, tlen=tlen,
                block_m=bm))
        except (RuntimeError, ValueError) as e:   # a row height refused
            res[f"windowed_bm{bm}"] = {"failed": type(e).__name__,
                                       "error": str(e)[:200]}
    res["sdpa_yardstick"] = line(
        lambda: F.scaled_dot_product_attention(q, k, v))
    res.update(shape=[b, heads, s, d], flops=flops, iters=iters,
               **device_info(dev))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="2,048 tokens at 4 heads (a CPU rehearsal)")
    ap.add_argument("--tokens", type=int, default=None,
                    help="sequence length (overrides the point's)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
