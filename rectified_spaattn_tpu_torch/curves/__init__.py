from .gilbert import (
    gilbert3d_path,
    gilbert_mapping,
    sliced_gilbert_mapping,
    gilbert_block_neighbor_mask,
    sliced_gilbert_block_neighbor_mask,
    block_wise_mapping,
)
from .cache import cached_curve

__all__ = [
    "gilbert3d_path",
    "gilbert_mapping",
    "sliced_gilbert_mapping",
    "gilbert_block_neighbor_mask",
    "sliced_gilbert_block_neighbor_mask",
    "block_wise_mapping",
    "cached_curve",
]
