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


# PTX of the pre-Hopper operand path (warp-level mma, ldmatrix, 16-byte
# cp.async); the kernels run on wgmma fed by TMA (cp.async.bulk.tensor)
PRE_HOPPER_PTX = ("mma.sync", "ldmatrix.sync", "cp.async.cg", "cp.async.ca",
                  "cp.async.commit_group", "cp.async.wait_group")


def test_csrc_has_no_pre_hopper_ptx():
    """No string literal of a CUDA source or header (the inline PTX among
    them) names mma.sync, ldmatrix or a non-bulk cp.async."""
    found = []
    for name in sorted(os.listdir(cuda_build.CSRC)):
        if not name.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(cuda_build.CSRC, name)) as f:
            code = re.sub(r"//[^\n]*", "", f.read())
        for lit in re.findall(r'"(?:[^"\\\n]|\\.)*"', code):
            found += [(name, op) for op in PRE_HOPPER_PTX if op in lit]
    assert not found, found


def _sass(**s1_int8):
    """A build's SASS table as chip_smoke.sass_counts gives it (names from
    an H100 build), S1's int8 counts overridden by ``s1_int8``."""
    zero = {"BRA": 0, "FSEL": 0, "HGMMA": 0, "IGMMA": 0, "HMMA": 0,
            "IMMA": 0, "UTMALDG": 0}
    s1 = "11loop_kernelILb{}EEEvNS_5ProbeIXT_EE6ParamsE"
    return {
        "int8_probe": {s1.format(1): {**zero, "IGMMA": 20, "UTMALDG": 2,
                                      **s1_int8},
                       s1.format(0): {**zero, "HGMMA": 41, "UTMALDG": 4}},
        "dense_flash": {"18hopper_attn_kernelI13__nv_bfloat16E": {
            **zero, "HGMMA": 16, "UTMALDG": 12}}}


@pytest.mark.parametrize("case", ["ok", "imma", "no_igmma", "no_tma",
                                  "hmma_elsewhere", "no_cuobjdump"])
def test_chip_smoke_sass_check(case):
    """chip_smoke.check_sass passes S1 on wgmma fed by TMA and fails a
    warp-level mma anywhere, a missing wgmma or TMA load, or an unread
    library."""
    import chip_smoke
    sass = _sass(**{"ok": {}, "imma": {"IMMA": 8}, "no_igmma": {"IGMMA": 0},
                    "no_tma": {"UTMALDG": 0}}.get(case, {}))
    if case == "hmma_elsewhere":
        next(iter(sass["dense_flash"].values()))["HMMA"] = 4
    if case == "no_cuobjdump":
        sass["variants"] = {"cuobjdump": "not found"}
    if case == "ok":
        chip_smoke.check_sass(sass)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_sass(sass)
