from .hunyuan import HunyuanVideoConfig, HunyuanVideoDiT, TokenRefiner
from .wan import WanConfig, WanDiT
from .cogvideox import CogVideoXBlock, CogVideoXConfig, CogVideoXDiT
from .flux import (FluxConfig, FluxControlNet, FluxControlNetConfig, FluxDiT,
                   distribute_controlnet_samples, init_controlnet_weights)
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
    "FluxConfig", "FluxDiT", "FluxControlNetConfig", "FluxControlNet",
    "distribute_controlnet_samples", "init_controlnet_weights",
    "VAEConfig", "VAEDecoder", "VAEEncoder", "tiled_decode",
    "HashEncoder", "TransformersTextEncoder", "make_text_encoder",
    "init_random_weights", "flax_to_state_dict", "load_flax_params",
    "layers", "quant", "weights", "QLinear", "quantize_model",
    "quantize_state_dict", "quantized_nbytes",
]
