"""The harness is driven by its files: a configuration, a traffic mix, a
limits file and a per-layer metric added as new files, with new entries in
BENCHMARK.json, run without an edit to any file that is there."""

from __future__ import annotations

import json
import os
import shutil

from perfbench import harness
from perfbench.tests.conftest import SEED, tiny


def test_new_config_traffic_and_metric_are_files(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    here = root / "perfbench"
    for d in ("configs", "traffic", "limits", "metrics", "data"):
        shutil.copytree(os.path.join(harness.HERE, d), here / d)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    conf = json.loads((here / "configs/hunyuanvideo-t2v-720p.json")
                      .read_text())
    conf.update(name="hunyuanvideo-t2v-544p", num_layers=2,
                num_single_layers=4,
                video={"height": 544, "width": 960, "frames": 128})
    (here / "configs/hunyuanvideo-t2v-544p.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic/sparse-50step.json").read_text())
    traffic.update(num_steps=30, text_valid=64)
    (here / "traffic/short-prompt-30step.json").write_text(
        json.dumps(traffic))
    (here / "limits/hunyuan-t2v-544p.short.json").write_text(
        (here / "limits/hunyuan-t2v-720p.sparse.json").read_text())
    (here / "metrics/plan_share.py").write_text(
        "def read(r):\n"
        "    ops = [o for o in r.ops if r.in_plan(o)]\n"
        "    return 100 * r.sum_ms(ops) / r.sum_ms(r.ops) if ops else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "hunyuanvideo-t2v-544p", "source": conf["source"],
        "file": "perfbench/configs/hunyuanvideo-t2v-544p.json",
        "reduced": ["num_layers", "num_single_layers"], "why": "544p"})
    cell = "hunyuan-t2v-544p.short"
    bench["workloads"].append({
        "name": cell, "config": "hunyuanvideo-t2v-544p",
        "traffic": "short-prompt-30step", "chips": 1, "why": "544p"})
    bench["per_layer"].append({
        "name": "plan_share", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "attention site and plan",
        "moves": "step_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []

    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(here))
    spec = harness.cell_spec(cell)
    assert spec["config"]["name"] == "hunyuanvideo-t2v-544p"
    assert spec["traffic"]["num_steps"] == 30
    assert "plan_share" in [m["name"] for m in spec["per_layer"]]
    over = tiny("hunyuan")
    over["traffic"] = {**over["traffic"], "num_steps": 6}
    res = harness.run_cell(cell, SEED, 1e6, True, device="cpu",
                           overrides=over)
    assert res["limits_ok"], res["numbers"]
    assert "step_s" in harness.result_line(cell, res, False)["metrics"]
    line = harness.result_line(cell, res, True)
    assert line["correct"] is True
    # a reader that finds nothing to read (no device work on the CPU)
    # returns nothing, and the metric is left out of the line
    assert "plan_share" not in line["metrics"]
    assert harness.metric_reader("plan_share") is not None
