"""Every cell end to end at a tiny size on the CPU (the port's plain
versions), its result line, and the check that decides ``correct``: the
program passes it, the float8 control and the faults of the timed path
fail it."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import check, harness
from perfbench.tests.conftest import SEED, tiny
from rectified_spaattn_tpu_torch.attention import rectified

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(name, fam, precision="bfloat16", traced=False, **kw):
    return harness.run_cell(name, SEED, 1e6, traced, device="cpu",
                            overrides=tiny(fam, precision), **kw)


@pytest.mark.parametrize("traced", [False, True])
def test_every_cell_prints_the_result_line(cells, traced):
    for name, fam in cells:
        res = run(name, fam, traced=traced)
        line = harness.result_line(name, res, traced)
        want = KEYS + (["breakdown"] if traced else []) + ["checks"]
        assert list(line) == want, name
        assert line["correct"] is True, (name, line["checks"])
        assert line["attempted"] >= 1 and line["failed"] == 0
        json.dumps(line)
        if traced:
            # the steps after the traced ones, with the profiler stopped
            ts = harness.cell_spec(name)["traffic"]["trace_steps"]
            assert len(res["untraced_step_s"]) == ts
            assert res["reading"].step_s > 0
        if not traced:
            want = {m["name"] for m in harness.cell_spec(name)["end_to_end"]}
            assert set(line["metrics"]) == want - {"peak_mem_gb"}  # no card
            assert all(m["value"] > 0 for m in line["metrics"].values())


def test_program_matches_reference_in_float32(cells):
    """With float32 weights the program and the reference differ by
    rounding alone, in every number and every cell."""
    for name, fam in cells:
        nums = run(name, fam, "float32")["numbers"]
        assert nums["curve_mismatch"] == 0 and nums["lists_mismatch"] == 0
        assert nums.get("sched_mismatch", 0) == 0
        assert nums["plan_mask_mismatch"] == 0.0, name
        for k, v in nums.items():
            if k.endswith(("rel_l2", "max_gap")):
                assert v < 1e-4, (name, k, v)


def test_control_fails(cells):
    """The reference in float8 in the program's place is not correct."""
    for name, fam in cells:
        res = run(name, fam, "float32", control=True)
        ctl = res["control_numbers"]
        limits = harness.cell_spec(name)["limits"]
        ok, _ = check.verdict(ctl, {k: limits[k] for k in ctl})
        assert not ok, (name, res["control_numbers"])


def _frozen(cls):
    """``cls`` (a sampler) whose step returns its state unchanged."""
    class Frozen(cls):
        def step(self, model_out, sample, i):
            return sample.clone()
    return Frozen


def _k2_fault(fn):
    orig = rectified.block_sparse_flash_attention_grouped

    def broken(q, *a, **kw):
        return fn(orig(q, *a, **kw))
    return broken


def _altered(out):
    """One query block of one head answered wrong."""
    out = out.clone()
    out[:, 0, :128] += 1.0
    return out


def _half_heads(out):
    """Half of the heads' attention left out."""
    out = out.clone()
    out[:, : out.shape[1] // 2] = 0
    return out


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_heads_left_out"])
def test_faults_fail(cells, monkeypatch, fault):
    for name, fam in cells:
        def plant(pipe):
            if fault == "state_unchanged":
                mod, attr = harness.family(fam).SCHEDULER
                monkeypatch.setattr(mod, attr, _frozen(getattr(mod, attr)))
            else:
                fn = _altered if fault == "answer_altered" else _half_heads
                monkeypatch.setattr(rectified,
                                    "block_sparse_flash_attention_grouped",
                                    _k2_fault(fn))
        res = run(name, fam, "float32", fault=plant)
        monkeypatch.undo()
        line = harness.result_line(name, res, False)
        assert line["correct"] is False, (name, fault, res["numbers"])


def test_nonfinite_latents_fail_the_step(monkeypatch):
    name, fam = "hunyuan-t2v-720p.sparse", "hunyuan"

    def plant(pipe):
        monkeypatch.setattr(rectified, "block_sparse_flash_attention_grouped",
                            _k2_fault(lambda o: o * float("nan")))
    res = run(name, fam, "float32", fault=plant)
    assert res["failed"] == res["attempted"] >= 1
    assert harness.result_line(name, res, False)["correct"] is False


def test_window_holds_whole_patterns():
    """The TeaCache cell's window closes only after a skip + compute pair,
    so its mean step time does not swing with where the clock ran out."""
    w = harness.Window(torch.device("cpu"), 1, 0.0, 0, set(), 1, multiple=2)
    steps = [i for i, _ in zip(range(50), w.walk(range(50)))]
    assert steps == [0, 1, 2]
