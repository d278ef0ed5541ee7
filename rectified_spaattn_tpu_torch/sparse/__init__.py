from .config import SparseConfig, select_block_num
from .pipeline import SparsePlan, build_sparse_plan
from . import ops

__all__ = [
    "SparseConfig",
    "select_block_num",
    "SparsePlan",
    "build_sparse_plan",
    "ops",
]
