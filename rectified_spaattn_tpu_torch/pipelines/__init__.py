from .schedulers import (FlowMatchEulerScheduler, UniPCScheduler,
                         flow_shift_timesteps)
from .base import (SparseSite, build_site, pad_tokens,
                   classifier_free_guidance, param_compute_dtype)
from .hunyuan import HunyuanVideoPipeline
from .wan import WanPipeline

__all__ = [
    "FlowMatchEulerScheduler", "UniPCScheduler", "flow_shift_timesteps",
    "SparseSite", "build_site", "pad_tokens", "classifier_free_guidance",
    "param_compute_dtype", "HunyuanVideoPipeline", "WanPipeline",
]
