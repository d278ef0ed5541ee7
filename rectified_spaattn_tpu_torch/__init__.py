"""Rectified-SpaAttn on PyTorch + CUDA (NVIDIA Hopper, sm_90a).

The port of ``rectified_spaattn_tpu`` (JAX/Pallas), which stays in the
repository as the reference every module here is held against.  The port
imports nothing of the JAX package.  Layout mirrors it module for module:

- Gilbert curve precompute (copy, own native build)       (`curves/`)
- IPAR + GAPR + top-p/top-k plan build, torch ops          (`sparse/`)
- hand-written CUDA gather kernels K1/K2 + plain versions  (`kernels/`)
- rectified sparse attention and mode dispatch             (`attention/`)
- HunyuanVideo DiT and the Flax weight bridge              (`models/`)
- TeaCache                                                 (`cache/`)
- flow-match scheduler and the HunyuanVideo pipeline       (`pipelines/`)
- generation CLI (`--model hunyuan`)                       (`cli/`)

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel wrapper uses its plain version.
"""

__version__ = "0.1.0"
