"""The readers of the program's ``rsa.*`` host ranges against a hand-made
trace: one traced step (of two counted) whose ranges nest as the port's
do, device times on a clock of their own."""

from __future__ import annotations

import pytest

from perfbench import harness, spans
from perfbench.trace import Op, Reading

READERS = ("site_glue_ms", "rectify_ms", "host_syncs", "sync_idle_ms",
           "site_idle_ms")

HOST = [(0, 1000, "rsa.step"),
        (50, 90, "rsa.sync.teacache"),
        (100, 600, "rsa.site"),
        (110, 200, "rsa.plan"),
        (210, 300, "rsa.attn"),
        (250, 290, "rsa.sync.lists"),
        (310, 400, "rsa.rectify"),
        (410, 500, "rsa.text"),
        (450, 490, "rsa.sync.lists"),
        (505, 520, "aten::cat"),
        (900, 990, "rsa.sync.step"),
        (992, 998, "rsa.sync.tp")]

# name, device start, duration, host launch (ns)
OPS = [Op("embed", 9000, 500, 20),        # the step: the model
       Op("cat", 10000, 100, 105),        # the site itself, after 500 idle
       Op("plan", 10100, 50, 150),
       Op("max", 10150, 10, 260),         # inside the first list readback
       Op("K2", 10300, 200, 295),         # after 140 idle
       Op("mul", 10500, 40, 320),         # rectification
       Op("add", 10540, 20, 330),
       Op("max", 10560, 10, 460),         # inside the second readback
       Op("K1", 10600, 50, 492),          # after 30 idle
       Op("cat", 10650, 25, 550),         # the site itself
       Op("linear", 10700, 100, 700),     # the model, after 25 idle
       Op("copy", 11000, 10, 1100),       # after both step-end readbacks
       Op("memset", 11010, 5, -1)]        # no runtime call matched


def reading(host=HOST, ops=OPS, steps=2):
    return Reading(steps=steps, window_s=2e-6, step_s=1e-6, ops=list(ops),
                   plan_ranges=[(110, 200)], gemm_flops=0.0,
                   attn_flops=0.0, attn_bound_s=0.0, host=sorted(host))


def test_each_operation_belongs_to_the_ranges_around_its_launch():
    names = spans.enclosing(reading())
    assert names[0] == ("rsa.step",)
    assert names[1] == names[9] == ("rsa.step", "rsa.site")
    assert names[3] == ("rsa.step", "rsa.site", "rsa.attn", "rsa.sync.lists")
    assert names[4] == ("rsa.step", "rsa.site", "rsa.attn")
    assert names[5] == names[6] == ("rsa.step", "rsa.site", "rsa.rectify")
    assert names[8] == ("rsa.step", "rsa.site", "rsa.text")
    assert names[10] == ("rsa.step",)
    assert names[11] == names[12] == ()


def test_readers_by_hand():
    r = reading()
    read = {m: harness.metric_reader(m) for m in READERS}
    # the site's own operations: the two cats, 100 + 25 ns over 2 steps
    assert read["site_glue_ms"](r) == pytest.approx(125e-6 / 2)
    assert read["rectify_ms"](r) == pytest.approx(60e-6 / 2)
    # TeaCache's, two list checks, the step's end, the tp vote
    assert read["host_syncs"](r) == 5 / 2
    # the gaps before cat (500, after TeaCache's readback), K2 (140), K1
    # (30) and copy (200, after the two step-end readbacks: once); the
    # 25 before linear follows no readback
    assert read["sync_idle_ms"](r) == pytest.approx(870e-6 / 2)
    # the gaps ended by an operation launched inside rsa.site
    assert read["site_idle_ms"](r) == pytest.approx(670e-6 / 2)


def test_readers_find_nothing_to_read():
    """A program without the ranges (the harness's own ranges and the
    host's ops alone), or no traced step, gives ``None``."""
    bare = [h for h in HOST if not h[2].startswith("rsa.")]
    for r in (reading(host=bare), reading(steps=0)):
        for m in READERS:
            assert harness.metric_reader(m)(r) is None, m


def test_ranges_with_no_device_work_read_zero():
    r = reading(ops=[])
    assert harness.metric_reader("host_syncs")(r) == 5 / 2
    for m in ("site_glue_ms", "rectify_ms", "sync_idle_ms", "site_idle_ms"):
        assert harness.metric_reader(m)(r) == 0, m
