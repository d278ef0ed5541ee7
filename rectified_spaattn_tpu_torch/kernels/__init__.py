from .block_sparse import (
    block_sparse_flash_attention,
    block_sparse_flash_attention_grouped,
    block_sparse_flash_attention_paired,
    block_sparse_flash_attention_torch,
    block_sparse_flash_attention_split_torch,
    block_sparse_flash_attention_grouped_torch,
    block_sparse_attention_reference,
)
from .cuda_build import build_kernels
from .flash import dense_attention, dense_flash_attention
from . import int8_probe, variants

__all__ = [
    "block_sparse_flash_attention",
    "block_sparse_flash_attention_grouped",
    "block_sparse_flash_attention_paired",
    "block_sparse_flash_attention_torch",
    "block_sparse_flash_attention_split_torch",
    "block_sparse_flash_attention_grouped_torch",
    "block_sparse_attention_reference",
    "build_kernels",
    "dense_attention",
    "dense_flash_attention",
    "int8_probe",
    "variants",
]
