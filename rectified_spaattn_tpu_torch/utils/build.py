"""Where the port's native artefacts go: the Gilbert walker, the CUDA
kernels' shared library and the curve cache all land in ``build/`` inside
the package (listed in .gitignore), so a run writes nothing outside its
checkout."""

from __future__ import annotations

import os

BUILD_DIR = os.environ.get(
    "RSA_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "build"))
