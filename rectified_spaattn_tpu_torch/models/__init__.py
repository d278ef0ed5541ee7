from .hunyuan import HunyuanVideoConfig, HunyuanVideoDiT, TokenRefiner
from .wan import WanConfig, WanDiT
from .cogvideox import CogVideoXBlock, CogVideoXConfig, CogVideoXDiT
from .vae import VAEConfig, VAEDecoder, VAEEncoder, tiled_decode
from .encoders import HashEncoder, TransformersTextEncoder, make_text_encoder
from .layers import init_random_weights
from .convert import flax_to_state_dict, load_flax_params
from .quant import (QLinear, quantize_model, quantize_state_dict,
                    quantized_nbytes)
from . import layers, quant, weights

__all__ = [
    "HunyuanVideoConfig", "HunyuanVideoDiT", "TokenRefiner", "WanConfig",
    "WanDiT", "CogVideoXBlock", "CogVideoXConfig", "CogVideoXDiT",
    "VAEConfig", "VAEDecoder", "VAEEncoder", "tiled_decode",
    "HashEncoder", "TransformersTextEncoder", "make_text_encoder",
    "init_random_weights", "flax_to_state_dict", "load_flax_params",
    "layers", "quant", "weights", "QLinear", "quantize_model",
    "quantize_state_dict", "quantized_nbytes",
]
