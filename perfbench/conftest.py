"""The Wan cell's tiny sizes, added to the shared table of
perfbench/tests/conftest.py (pytest loads this file first).

At 2 x 16 x 30 tokens the visual region pads to 8 blocks and the first
frame holds 3 of them.  ``group_rows`` 2 runs K2, whose faults the
every-cell tests plant; perfbench/tests/test_perfbench_wan.py runs the
cell's own G = 1 as well.  The window opens past the dense warm calls
(4 here) and the first sparse step, as at full size."""

from perfbench.tests import conftest as shared

shared.TINY["wan"] = {
    "num_attention_heads": 2, "attention_head_dim": 32, "num_layers": 4,
    "ffn_dim": 128, "text_dim": 32, "freq_dim": 32, "text_len": 64,
    "rope_axes_dim": [12, 10, 10],
    "video": {"height": 256, "width": 480, "frames": 5},
    "site": {"sa_drop_rate": 0.75, "p_remain": 0.3, "group_rows": 2,
             "warm_layers": 2, "warm_calls": 4,
             "first_frame_retention": True},
    "traffic": {"num_steps": 8, "window_from_step": 3, "text_valid": 40}}
