"""Shared tiny sizes: every cell's configuration and traffic cut so that a
run takes a second on the CPU through the port's plain versions."""

from __future__ import annotations

import pytest

TINY = {
    "hunyuan": {
        "num_attention_heads": 2, "attention_head_dim": 32, "num_layers": 1,
        "num_single_layers": 1, "num_refiner_layers": 1,
        "text_embed_dim": 32, "pooled_projection_dim": 16,
        "rope_axes_dim": [8, 12, 12],
        "video": {"height": 128, "width": 256, "frames": 16},
        "site": {"sa_drop_rate": 0.8, "p_remain": 0.3, "group_rows": 2,
                 "text_len": 128},
        "traffic": {"num_steps": 8, "check_within": 4}},
    # two blocks: with one, attention's share of the output is too small
    # for a fault in it to show at this size
    "cogvideox": {
        "num_attention_heads": 2, "attention_head_dim": 32, "num_layers": 2,
        "text_embed_dim": 32, "time_embed_dim": 32,
        "rope_axes_dim": [8, 12, 12],
        # 2 x 8 x 15 tokens (3 latent frames, padded to 4): the visual
        # region pads to two blocks
        "video": {"height": 128, "width": 240, "frames": 9},
        "site": {"sa_drop_rate": 0.85, "p_remain": 0.3, "group_rows": 2,
                 "text_len": 128, "sparse_warm_calls": 5},
        "traffic": {"num_steps": 8, "text_valid": 100}},
}
SEED = 2 ** 31 + 12345          # above 32 signed bits, as seeds may be


def tiny(family: str, precision: str = "bfloat16") -> dict:
    return {**TINY[family], "precision": precision}


@pytest.fixture
def cells():
    from perfbench import harness
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    return [(w["name"], harness.cell_spec(w["name"])["config"]["family"])
            for w in bench["workloads"]]
