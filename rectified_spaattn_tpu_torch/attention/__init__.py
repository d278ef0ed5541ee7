from .rectified import rectified_sparse_attention, kv_validity
from .modes import attention, DENSE_MODES
from .sharded import head_parallel_rectified_attention
from .ring import ring_rectified_sparse_attention

__all__ = [
    "rectified_sparse_attention",
    "kv_validity",
    "attention",
    "DENSE_MODES",
    "head_parallel_rectified_attention",
    "ring_rectified_sparse_attention",
]
