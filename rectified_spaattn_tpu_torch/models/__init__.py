from .hunyuan import (HunyuanVideoConfig, HunyuanVideoDiT, TokenRefiner,
                      init_random_weights)
from .convert import flax_to_state_dict, load_flax_params
from . import layers

__all__ = [
    "HunyuanVideoConfig", "HunyuanVideoDiT", "TokenRefiner",
    "init_random_weights", "flax_to_state_dict", "load_flax_params",
    "layers",
]
