"""The port's CUDA sources (rectified_spaattn_tpu_torch/csrc) through the
host compiler: g++ -fsyntax-only with the stand-in CUDA headers of
tests/cuda_host_stubs, each kernel launch (``<<<...>>>``) rewritten as a
plain call.  It checks names, types, syntax and every template the
sources instantiate (the mainloop's policies among them) where there is
no nvcc; it neither generates code nor reads inline PTX, which only the
card's build (chip_smoke.py) checks.  Skips where there is no g++.
"""

import os
import re
import shutil
import subprocess

import pytest

from rectified_spaattn_tpu_torch.kernels import cuda_build

STUBS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "cuda_host_stubs")


@pytest.mark.parametrize("source", cuda_build.SOURCES)
def test_csrc_passes_host_syntax_check(tmp_path, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host-compiler check")
    for name in (f"{source}.cu", *cuda_build.HEADERS):
        with open(os.path.join(cuda_build.CSRC, name)) as f:
            text = f.read()
        (tmp_path / name).write_text(re.sub(r"<<<.*>>>", "", text))
    proc = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
         "-I", STUBS, "-x", "c++", str(tmp_path / f"{source}.cu")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
