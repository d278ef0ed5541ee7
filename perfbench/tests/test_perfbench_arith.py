"""The per-layer metrics' arithmetic against hand-counted shapes and a
hand-made trace; the yardstick's imports."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from perfbench import harness, peaks, trace
from perfbench.run import FORBIDDEN
from perfbench.trace import Op, Reading


def reader(name):
    return harness.metric_reader(name)


def test_attention_call_counts():
    # one head, 4 visual row blocks keeping 3 key blocks each (12 pairs,
    # 5 distinct blocks used), 128 text rows over 5 key blocks, d = 64
    fl, bound = peaks.attention_call(12, 5, b=1, h=1, rows_visual=512, d=64,
                                     text_len=128, key_blocks=5)
    pair = 4 * 128 * 128 * 64
    assert fl == 12 * pair + 5 * pair
    vis = max(12 * pair / 989e12,
              (2 * 512 * 64 * 2 + 2 * 5 * 128 * 64 * 2) / 3.35e12)
    txt = max(5 * pair / 989e12,
              (2 * 128 * 64 * 2 + 2 * 5 * 128 * 64 * 2) / 3.35e12)
    assert bound == pytest.approx(vis + txt, rel=1e-12)


def _reading(**kw):
    ops = [Op("nvjet_tst_256x128_h_bz_TNT", 0, 400, 5),
           Op("void (anonymous namespace)::hopper_attn_kernel<bf16>", 500,
              300, 20),
           Op("merge_splits_kernel", 800, 100, 30),
           Op("void at::native::reduce_kernel<...>", 1000, 100, 110),
           Op("Memset (Device)", 1050, 100, 120)]
    base = dict(steps=2, window_s=3e-6, step_s=1e-6, ops=ops,
                plan_ranges=[(100, 200)],
                gemm_flops=1e9, attn_flops=1e9, attn_bound_s=2e-7)
    return Reading(**{**base, **kw})


def test_readers_on_a_hand_made_trace():
    r = _reading()
    # busy: [0,400] + [500,900] + [1000,1150] = 950 ns over 2 steps, of
    # 1000 ns a step with the profiler stopped (the traced 1500 a step
    # divide nothing)
    assert reader("device_idle_pct")(r) == pytest.approx(52.5)
    assert reader("gemm_ms")(r) == pytest.approx(400e-6 / 2)
    assert reader("attn_kernel_ms")(r) == pytest.approx(400e-6 / 2)
    # the reduce and the memset were queued at 110 and 120 ns, inside the
    # plan's host range [100, 200]
    assert reader("plan_launches")(r) == 1.0
    assert reader("plan_ms")(r) == pytest.approx(200e-6 / 2)
    assert reader("step_mfu")(r) == pytest.approx(
        100 * 1e9 / (1e-6 * 989e12))
    assert reader("attn_roofline")(r) == pytest.approx(100 * 2e-7 / 400e-9)
    b = trace.breakdown(r)
    assert b["device_ops"][0] == ["nvjet_tst_256x128_h_bz_TNT", 400e-9]
    assert [g for _, g in b["idle_gaps"]] == [100e-9, 100e-9]


def test_idle_share_shows_a_busy_count_above_the_step():
    """No clamp: device work longer than the step it ran in reads below
    0, so that a wrong busy count shows."""
    assert reader("device_idle_pct")(_reading(step_s=4e-7)) < 0


def test_readers_find_nothing_to_read():
    r = _reading(ops=[], gemm_flops=0.0, attn_flops=0.0, attn_bound_s=0.0)
    for m in ("step_mfu", "device_idle_pct", "gemm_ms", "plan_ms",
              "plan_launches", "attn_kernel_ms", "attn_roofline"):
        assert reader(m)(r) is None, m


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_the_yardstick():
    for dirpath, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if d != "out"]   # local runs' leftovers
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & set(FORBIDDEN), (path, tops)
    code = ("import sys; import perfbench.harness, perfbench.run; "
            "from perfbench.families import hunyuan, cogvideox; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & set(FORBIDDEN), loaded
    assert "rectified_spaattn_tpu_torch" in loaded


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert "rectified_spaattn_tpu_torch" not in tops, f
