from .schedulers import (CogVideoXDDIMScheduler, FlowMatchEulerScheduler,
                         UniPCScheduler, dynamic_cfg_scale,
                         flow_shift_timesteps, flux_mu_shift)
from .base import (SparseSite, build_site, pad_tokens,
                   classifier_free_guidance, param_compute_dtype)
from .hunyuan import (HunyuanVideoPipeline, i2v_condition_concat,
                      i2v_first_frame)
from .wan import (Wan22A14BPipeline, WanPipeline, i2v_condition,
                  ti2v_first_frame)
from .cogvideox import CogVideoXPipeline, cog_i2v_condition
from .flux import (FluxPipeline, FluxUpscalePipeline, flux_pack_latents,
                   flux_unpack_latents, resize_bicubic)

__all__ = [
    "FlowMatchEulerScheduler", "UniPCScheduler", "flow_shift_timesteps",
    "SparseSite", "build_site", "pad_tokens", "classifier_free_guidance",
    "param_compute_dtype", "HunyuanVideoPipeline", "WanPipeline",
    "Wan22A14BPipeline", "i2v_condition_concat", "i2v_first_frame",
    "i2v_condition", "ti2v_first_frame", "CogVideoXDDIMScheduler",
    "dynamic_cfg_scale", "CogVideoXPipeline", "cog_i2v_condition",
    "flux_mu_shift", "FluxPipeline", "FluxUpscalePipeline",
    "flux_pack_latents", "flux_unpack_latents", "resize_bicubic",
]
