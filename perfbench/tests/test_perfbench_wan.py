"""The Wan cell at a tiny size on the CPU at its own G = 1 (the every-cell
tests of test_perfbench_run.py run it at G = 2): the check passes the
program and fails the float8 control and faults of the timed path; a
traced run carries the program's dense ranges with their sizes; the
cell's readers against a hand-made trace."""

from __future__ import annotations

import math

import pytest

from perfbench import check, dense_peaks, harness
from perfbench.tests.conftest import SEED, tiny
from perfbench.trace import Op, Reading
from rectified_spaattn_tpu_torch.attention import rectified

CELL = "wan2.1-t2v-720p.sparse"
READERS = ("wan_step_mfu", "warm_dense_ms", "warm_dense_roofline",
           "cross_attn_ms", "cross_attn_roofline", "visual_attn_roofline")


def run(precision="float32", traced=False, **kw):
    over = tiny("wan", precision)
    over["site"] = {**over["site"], "group_rows": 1}
    return harness.run_cell(CELL, SEED, 1e6, traced, device="cpu",
                            overrides=over, **kw)


def test_program_passes_and_control_fails():
    res = run(control=True)
    nums = res["numbers"]
    # K1's own lists at G = 1, checked in the window
    assert nums["lists_mismatch"] == 0 and nums["curve_mismatch"] == 0
    assert nums["plan_mask_mismatch"] == 0.0
    assert nums["call_rel_l2"] < 1e-5 and nums["call_max_gap"] < 1e-5
    # UniPC redone from the program's outputs and latents: the step's and
    # the two before it
    assert nums["sched_max_gap"] < 1e-5
    assert harness.result_line(CELL, res, False)["correct"] is True
    limits = harness.cell_spec(CELL)["limits"]
    ctl = res["control_numbers"]
    ok, _ = check.verdict(ctl, {k: limits[k] for k in ctl})
    assert not ok, ctl


def test_bf16_program_passes():
    line = harness.result_line(CELL, run("bfloat16"), False)
    assert line["correct"] is True, line["checks"]


def _k1_altered(monkeypatch):
    orig = rectified.block_sparse_flash_attention

    def broken(*a, **kw):
        out = orig(*a, **kw).clone()
        out[:, 0, :128] += 1.0
        return out
    monkeypatch.setattr(rectified, "block_sparse_flash_attention", broken)


def _lists_reversed(monkeypatch):
    """K1's index lists handed over in descending order."""
    orig = rectified.build_sparse_plan

    def broken(*a, **kw):
        plan = orig(*a, **kw)
        idx = plan.indices.clone()
        n = int(plan.counts[0, 0, 0])
        idx[0, 0, 0, :n] = plan.indices[0, 0, 0, :n].flip(-1)
        return plan._replace(indices=idx)
    monkeypatch.setattr(rectified, "build_sparse_plan", broken)


def _warm_gate_off(monkeypatch, pipe):
    monkeypatch.setattr(pipe, "warm_layers", 0)


def _state_unchanged(monkeypatch):
    """UniPC's step returns the latents it was given."""
    mod, attr = harness.family("wan").SCHEDULER

    class Frozen(getattr(mod, attr)):
        def step(self, model_out, sample, i):
            return sample.clone()
    monkeypatch.setattr(mod, attr, Frozen)


def _history_stale(monkeypatch):
    """UniPC keeps the newest x0 in both of its history's places, so its
    order-2 terms vanish: a fault of the sampler's own bookkeeping."""
    mod, attr = harness.family("wan").SCHEDULER

    class Stale(getattr(mod, attr)):
        def step(self, model_out, sample, i):
            out = super().step(model_out, sample, i)
            self._model_outputs[-2] = self._model_outputs[-1]
            return out
    monkeypatch.setattr(mod, attr, Stale)


@pytest.mark.parametrize("fault,number", [
    ("k1_answer_altered", "call_rel_l2"),
    ("k1_lists_reversed", "lists_mismatch"),
    # the harness keeps the step's first plan: layer 0's, not layer 2's
    ("warm_gate_off", "plan_mask_mismatch"),
    ("state_unchanged", "sched_max_gap"),
    ("history_stale", "sched_max_gap")])
def test_faults_fail(monkeypatch, fault, number):
    def plant(pipe):
        if fault == "k1_answer_altered":
            _k1_altered(monkeypatch)
        elif fault == "k1_lists_reversed":
            _lists_reversed(monkeypatch)
        elif fault == "warm_gate_off":
            _warm_gate_off(monkeypatch, pipe)
        elif fault == "history_stale":
            _history_stale(monkeypatch)
        else:
            _state_unchanged(monkeypatch)
    res = run(fault=plant)
    monkeypatch.undo()
    line = harness.result_line(CELL, res, False)
    assert line["correct"] is False, (fault, res["numbers"])
    limit = harness.cell_spec(CELL)["limits"][number]
    assert res["numbers"][number] > limit, (fault, res["numbers"])


def test_a_port_with_other_sampler_coefficients_is_refused(monkeypatch):
    """UniPC with B(h) = h and the order-2 predictor's rho solved (the
    JAX package's form): the family refuses it before the model is
    built, so a run fails at once."""
    mod, attr = harness.family("wan").SCHEDULER

    def coeffs(hh):
        h_phi_1 = math.expm1(hh)
        h_phi_2 = h_phi_1 / hh - 1.0
        b1 = h_phi_2 / hh
        return h_phi_1, hh, b1, b1, (h_phi_2 / hh - 0.5) * 2.0 / hh
    monkeypatch.setattr(getattr(mod, attr), "_coeffs", staticmethod(coeffs))
    with pytest.raises(ValueError, match="published bh2"):
        run()


def test_traced_run_carries_the_dense_ranges():
    """The program's ``rsa.dense`` and ``rsa.cross`` ranges, named with
    their sizes, in the traced steps: per step two dense calls a stream
    (the warm layers) and one cross-attention call a layer and stream.
    The CPU runs no device operation, so the readers of device time give
    0 ms and no roofline share."""
    res = run(traced=True)
    assert harness.result_line(CELL, res, True)["correct"] is True
    r = res["reading"]
    c = tiny("wan")
    h, d = c["num_attention_heads"], c["attention_head_dim"]
    rows = 1024                 # 2 x 16 x 30 = 960 tokens, padded to a block
    dense = [n for _, _, n in r.host if n.startswith("rsa.dense")]
    cross = [n for _, _, n in r.host if n.startswith("rsa.cross")]
    assert dense == [f"rsa.dense:b=1,h={h},q={rows},k={rows},d={d}"] * (
        2 * 2 * r.steps)
    assert cross == [f"rsa.cross:b=1,h={h},q={rows},k=64,d={d}"] * (
        c["num_layers"] * 2 * r.steps)
    read = {m: harness.metric_reader(m)(r) for m in READERS}
    assert read["warm_dense_ms"] == 0 and read["cross_attn_ms"] == 0
    assert read["wan_step_mfu"] > 0
    assert read["warm_dense_roofline"] is None
    assert read["cross_attn_roofline"] is None
    assert read["visual_attn_roofline"] is None


def test_dense_call_counts():
    """The operations and bytes of the cell's two dense shapes, by hand."""
    assert dense_peaks.sizes("rsa.cross:b=1,h=40,q=75648,k=512,d=128") == {
        "b": 1, "h": 40, "q": 75648, "k": 512, "d": 128}
    assert dense_peaks.sizes("rsa.cross") is None
    fl, bound = dense_peaks.call(1, 40, 75648, 512, 128)
    assert fl == 4.0 * 40 * 75648 * 512 * 128
    assert bound == pytest.approx(fl / 989e12)            # bound by ops
    fl, bound = dense_peaks.call(1, 40, 75648, 75648, 128)
    assert bound == pytest.approx(fl / 989e12)
    assert bound == pytest.approx(0.1186, rel=1e-3)
    # one head of 128 queries over one key: bound by bytes
    fl, bound = dense_peaks.call(1, 1, 128, 1, 128)
    assert bound == pytest.approx(2 * 128 * (2 * 128 + 2) / 3.35e12)


# one traced step of two counted: a dense call, a cross call and a site
# call with its kernel; device times on a clock of their own
DENSE = "rsa.dense:b=1,h=1,q=1024,k=1024,d=128"
CROSS = "rsa.cross:b=1,h=1,q=1024,k=512,d=128"
HOST = [(0, 1000, "rsa.step"),
        (100, 200, DENSE),
        (300, 400, CROSS),
        (500, 700, "rsa.site"),
        (550, 650, "rsa.attn")]
OPS = [Op("pad", 10000, 100, 110),
       Op("hopper_attn_kernel<dense>", 10100, 2000, 150),
       Op("hopper_attn_kernel<cross>", 12100, 500, 350),
       Op("plan", 12600, 100, 520),
       Op("hopper_attn_kernel<sparse>", 12700, 400, 600),
       Op("merge_splits", 13100, 100, 620),
       Op("gemm", 13200, 1000, 800)]


def reading(host=HOST, ops=OPS):
    return Reading(steps=2, window_s=2e-5, step_s=1e-5, ops=list(ops),
                   plan_ranges=[], gemm_flops=1e9, attn_flops=2e9,
                   attn_bound_s=1e-7, host=sorted(host))


def test_readers_by_hand():
    r = reading()
    read = {m: harness.metric_reader(m)(r) for m in READERS}
    fd, bd = dense_peaks.call(1, 1, 1024, 1024, 128)
    fc, bc = dense_peaks.call(1, 1, 1024, 512, 128)
    assert read["warm_dense_ms"] == pytest.approx(2100e-6 / 2)
    assert read["warm_dense_roofline"] == pytest.approx(100 * bd / 2100e-9)
    assert read["cross_attn_ms"] == pytest.approx(500e-6 / 2)
    assert read["cross_attn_roofline"] == pytest.approx(100 * bc / 500e-9)
    # the site's kernel and its merge, not the dense and cross kernels
    assert read["visual_attn_roofline"] == pytest.approx(100 * 1e-7 / 500e-9)
    assert read["wan_step_mfu"] == pytest.approx(
        100 * (3e9 + fd + fc) / 2 / (1e-5 * 989e12))


def test_readers_find_nothing_to_read():
    """A program without the ranges (the parent's) gives None, as does a
    dense range without its sizes."""
    bare = [h for h in HOST if not h[2].startswith(("rsa.dense",
                                                    "rsa.cross"))]
    r = reading(host=bare)
    for m in READERS[:5]:
        assert harness.metric_reader(m)(r) is None, m
    unsized = [(a, b, n.split(":")[0]) for a, b, n in HOST]
    for m in READERS[:5]:
        assert harness.metric_reader(m)(reading(host=unsized)) is None, m
    no_attn = [h for h in HOST if h[2] != "rsa.attn"]
    assert harness.metric_reader("visual_attn_roofline")(
        reading(host=no_attn)) is None
