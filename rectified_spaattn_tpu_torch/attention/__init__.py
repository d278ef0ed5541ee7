from .rectified import rectified_sparse_attention, kv_validity
from .modes import attention, DENSE_MODES

__all__ = [
    "rectified_sparse_attention",
    "kv_validity",
    "attention",
    "DENSE_MODES",
]
