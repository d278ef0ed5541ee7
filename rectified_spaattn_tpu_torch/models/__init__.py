from .hunyuan import HunyuanVideoConfig, HunyuanVideoDiT, TokenRefiner
from .wan import WanConfig, WanDiT
from .layers import init_random_weights
from .convert import flax_to_state_dict, load_flax_params
from .quant import (QLinear, quantize_model, quantize_state_dict,
                    quantized_nbytes)
from . import layers, quant

__all__ = [
    "HunyuanVideoConfig", "HunyuanVideoDiT", "TokenRefiner", "WanConfig",
    "WanDiT", "init_random_weights", "flax_to_state_dict",
    "load_flax_params", "layers", "quant", "QLinear", "quantize_model",
    "quantize_state_dict", "quantized_nbytes",
]
