"""wan_step_mfu: a traced step's model FLOPs over a step's host-clock
seconds with the profiler stopped x the bf16 peak, in %: the linear
layers' (shapes x tokens, counted as they run), the sparse site's
kernels at their executed plans, and the dense attention calls'
(``rsa.dense``, the warm gate; ``rsa.cross``, the cross-attention) from
the sizes their ranges carry.  ``step_mfu`` leaves the dense calls out;
a program without those ranges gives None."""

from perfbench import dense_peaks, peaks


def read(r):
    dense = dense_peaks.calls(r, dense_peaks.DENSE)
    cross = dense_peaks.calls(r, dense_peaks.CROSS)
    if not dense or not cross or not r.steps or not r.step_s:
        return None
    flops = (r.gemm_flops + r.attn_flops + sum(f for f, _ in dense)
             + sum(f for f, _ in cross))
    return 100.0 * flops / r.steps / (r.step_s * peaks.PEAK_BF16_FLOPS)
