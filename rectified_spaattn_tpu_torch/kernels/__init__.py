from .block_sparse import (
    block_sparse_flash_attention,
    block_sparse_flash_attention_grouped,
    block_sparse_flash_attention_torch,
    block_sparse_flash_attention_grouped_torch,
    block_sparse_attention_reference,
    build_kernels,
)
from .flash import dense_attention

__all__ = [
    "block_sparse_flash_attention",
    "block_sparse_flash_attention_grouped",
    "block_sparse_flash_attention_torch",
    "block_sparse_flash_attention_grouped_torch",
    "block_sparse_attention_reference",
    "build_kernels",
    "dense_attention",
]
