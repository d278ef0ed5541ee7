"""step_mfu: a traced step's model FLOPs (the linear layers' shapes x
tokens, counted as they run, plus the attention kernels' kept pairs and
text rows) over a step's host-clock seconds with the profiler stopped
(the same run's steps after the traced ones) x the bf16 peak, in %."""

from perfbench import peaks


def read(r):
    flops = r.gemm_flops + r.attn_flops
    if not flops or not r.steps or not r.step_s:
        return None
    return 100.0 * flops / r.steps / (r.step_s * peaks.PEAK_BF16_FLOPS)
