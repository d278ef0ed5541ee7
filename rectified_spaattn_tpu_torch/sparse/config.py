"""Configuration for the rectified block-sparse attention pipeline.

Port of rectified_spaattn_tpu/sparse/config.py: every field and every
``__post_init__`` check is kept, so one configuration means the same site
in both packages."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """Static (trace-time) description of one sparse-attention site.

    Mirrors the knobs of the reference per-model processors
    (reference: rectified_spaattn/rectified_hunyuan_attn.py:419-427,
    rectified_wan21_attn.py:389-397) but centralised, per SURVEY §5's
    config-consolidation note.

    Attributes:
      block_m / block_n: query / key block sizes (the mask granularity).
      p_remain: top-p cumulative-probability threshold for block selection
        (reference CLI --p_remain_rates, default 0.3).
      top_k_floor: minimum number of blocks kept per (head, q-block) —
        ``select_block_num = (1 - sa_drop_rate) * num_visual_blocks``.
      layout: "joint"  = text tokens appended after visual tokens; visual
                          queries sparse, text queries dense, IPAR active
                          (Hunyuan / Flux / CogVideoX);
              "visual" = self-attention over visual tokens only, text in a
                          separate cross-attention (Wan 2.1 / 2.2).
      text_len: padded length of the text tail (joint layout only).
      first_frame_blocks: number of leading curve blocks force-included for
        every query in that range (Wan first-frame retention,
        reference: rectified_wan21_attn.py:270-271).
    """

    top_k_floor: int
    p_remain: float = 0.3
    block_m: int = 128
    block_n: int = 128
    layout: str = "joint"
    text_len: int = 0
    first_frame_blocks: int = 0
    # Execute ``group_rows`` query blocks per kernel launch unit over the
    # UNION of their key sets (kernels/block_sparse.py::
    # block_sparse_flash_attention_grouped, kernel K2); 1 disables
    # grouping and runs the single-row kernel K1.
    group_rows: int = 1
    # The JAX kernel's KV blocks per online-softmax chunk (see
    # ``kernel_chunk_blocks``); the CUDA kernels pick their own tile.
    chunk_blocks: int = 0
    # int8 KV gather ("int8" | "mxu8", sparse/ops.py::quantize_kv_blocks in
    # the JAX package).  Validated here; the port's kernels raise
    # NotImplementedError for it until the quantized kernel (K1q) is ported.
    kv_quant: str = "none"
    # Build the plan in row tiles of this many query blocks (0 = one
    # shot).  Every plan stage is row-separable, so tiling only bounds
    # the fp32 [B,H,rows,NK] temporaries (a long-context memory lever).
    plan_row_chunk: int = 0
    # Compute the plan's per-key-block column statistics (pooled K/V,
    # GAPR deviations) in tiles of this many key blocks (0 = one shot) —
    # the K/V-side companion of plan_row_chunk.
    plan_kv_tile: int = 0
    # Pack K|V into one [B,H,S,2D] stream at the top of the attention
    # call (attention/rectified.py); the kernels then read K and V from
    # the stream.  Requires a block-aligned visual region when the caller
    # passes the stream, and excludes kv_quant.
    kv_pack: bool = False
    # Run the attention site in tiles of this many heads (0 = all heads
    # in one pass).  Every stage is head-separable, so head tiling
    # divides all attention-path temporaries by H/head_chunk; must divide
    # the head count.
    head_chunk: int = 0
    # top-p/top-k selection implementation: "bisect" (threshold bisection
    # on fp32 bit patterns) or "sort" (the value-sort oracle).
    topp_impl: str = "bisect"

    def __post_init__(self):
        if self.layout not in ("joint", "visual"):
            raise ValueError(f"layout must be 'joint' or 'visual', got {self.layout!r}")
        if self.layout == "joint" and self.text_len % self.block_n != 0:
            raise ValueError("text_len must be padded to a multiple of block_n")
        if self.block_m != self.block_n:
            raise ValueError("block_m != block_n is not supported")
        if not 1 <= self.group_rows <= 8:
            raise ValueError("group_rows must be in [1, 8] (membership "
                             "bits pack into the union sort key)")
        if self.kv_quant not in ("none", "int8", "mxu8"):
            raise ValueError(
                f"kv_quant must be none|int8|mxu8, got {self.kv_quant!r}")
        if self.kv_quant != "none" and self.group_rows > 1:
            raise ValueError("kv_quant is not implemented for grouped rows")
        if self.kv_pack and self.kv_quant != "none":
            raise ValueError("kv_pack does not compose with kv_quant "
                             "(the quantized path carries its own packed "
                             "payload and pools from raw k/v)")
        if self.head_chunk < 0:
            raise ValueError("head_chunk must be >= 0")

    @property
    def kernel_chunk_blocks(self) -> int:
        """The JAX kernel's per-chunk block count (TPU VMEM-sized defaults
        of 24 single-row / 16 grouped, RESULTS_r3.md).  Kept so the field
        means the same in both packages; the CUDA kernels ignore it and
        pick their own tile (64 query rows x one 128-key block per step,
        kernels/block_sparse.py)."""
        if self.chunk_blocks:
            return self.chunk_blocks
        if self.group_rows == 1:
            return 24
        return 16 if self.group_rows <= 4 else max(2, 64 // self.group_rows)

    @property
    def text_blocks(self) -> int:
        return self.text_len // self.block_n


def select_block_num(sa_drop_rate: float, num_visual_blocks: int) -> int:
    """Floor on kept blocks from a drop rate
    (reference: scripts/main_hunyuan.py:249-254)."""
    return int((1.0 - sa_drop_rate) * num_visual_blocks)
