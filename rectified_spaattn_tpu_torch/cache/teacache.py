"""TeaCache — step-residual caching across diffusion steps (port of
rectified_spaattn_tpu/cache/teacache.py).

The whole transformer-stack residual (hidden_out - hidden_in) is cached; a
step is SKIPPED (residual re-applied) when the modulated input changed
little since the last computed step, as measured by an accumulated,
polynomial-rescaled relative-L1 signal (reference:
scripts/main_hunyuan.py:110-157).  The signal is computed on the device;
ONE scalar per step crosses to the host, where the sampler loop branches.

Not ported yet: the int8 residual encode, host offload of the residual and
schedule tracing (later slices).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# Polynomial rescaling coefficients for the raw rel-L1 signal
# (numpy.poly1d convention: highest power first; reference:
# main_hunyuan.py:118).
COEFFICIENTS: dict[str, list[float]] = {
    "hunyuan-video": [7.33226126e+02, -4.01131952e+02, 6.75869174e+01,
                      -3.14987800e+00, 9.61237896e-02],
    "identity": [1.0, 0.0],
}


def residual_value(x_out: torch.Tensor, x_in: torch.Tensor,
                   store: str = "bf16") -> torch.Tensor:
    """Encode the stack residual for record_residual_value: bf16, the
    reference's format (main_hunyuan.py:152)."""
    if store == "int8":
        raise NotImplementedError("the int8 TeaCache residual is not "
                                  "ported yet")
    if store != "bf16":
        raise ValueError(f"residual store must be bf16|int8, got {store!r}")
    return (x_out - x_in).to(torch.bfloat16)


def rel_l1_signal(modulated: torch.Tensor,
                  previous: torch.Tensor) -> torch.Tensor:
    """Device-side raw signal mean|Δ| / mean|prev| (reference:
    main_hunyuan.py:120), a 0-d fp32 tensor."""
    num = (modulated.float() - previous.float()).abs().mean()
    den = previous.float().abs().mean()
    return num / torch.clamp(den, min=1e-12)


@dataclasses.dataclass
class TeaCacheState:
    """Host-side state for one cached stream (cond or uncond)."""
    accumulated: float = 0.0
    previous_modulated: Optional[torch.Tensor] = None
    previous_residual: Optional[torch.Tensor] = None
    previous_residual_ctx: Optional[torch.Tensor] = None
    skipped_steps: int = 0
    computed_steps: int = 0


@dataclasses.dataclass
class TeaCache:
    """TeaCache controller.

    Args:
      thresh: accumulated-signal threshold (--rel_l1_thresh).
      num_steps: total forward CALLS (CFG counts each pass).
      coefficients: rescaling polynomial, or a key into COEFFICIENTS.
      ret_steps / cutoff_steps: calls outside [ret_steps, cutoff_steps)
        always compute (default [cfg_streams, num_steps - cfg_streams):
        Hunyuan's first/last-step forcing, main_hunyuan.py:114).
      cfg_streams: 2 for CFG even/odd dual state, else 1.
      signal_scale: multiplier on the raw signal before the polynomial.
      forced_schedule: per-call compute/skip list to replay instead of
        deciding from the signal; calls past its end compute.
    """
    thresh: float
    num_steps: int
    coefficients: list | str = "identity"
    ret_steps: Optional[int] = None
    cutoff_steps: Optional[int] = None
    cfg_streams: int = 1
    signal_scale: float = 1.0
    forced_schedule: Optional[Sequence[bool]] = None

    def __post_init__(self):
        coeffs = (COEFFICIENTS[self.coefficients]
                  if isinstance(self.coefficients, str) else self.coefficients)
        self._poly = np.poly1d(coeffs)
        self.reset()

    @property
    def enabled(self) -> bool:
        return self.thresh > 0 or self.forced_schedule is not None

    def reset(self):
        self.states = [TeaCacheState() for _ in range(self.cfg_streams)]
        self._call_count = 0
        self.decisions: list[bool] = []     # compute (True) / skip, per call

    def should_compute(self, modulated: torch.Tensor) -> bool:
        """Decide whether the transformer stack must run this call (one
        host readback of one scalar)."""
        cnt = self._call_count
        self._call_count += 1
        st = self.states[cnt % self.cfg_streams]

        if self.forced_schedule is not None:
            compute = (bool(self.forced_schedule[cnt])
                       if cnt < len(self.forced_schedule) else True)
        else:
            ret = (self.ret_steps if self.ret_steps is not None
                   else self.cfg_streams)
            cutoff = (self.cutoff_steps if self.cutoff_steps is not None
                      else self.num_steps - self.cfg_streams)
            if cnt < ret or cnt >= cutoff or st.previous_modulated is None:
                compute = True
                st.accumulated = 0.0
            else:
                raw = (float(rel_l1_signal(modulated, st.previous_modulated))
                       * self.signal_scale)
                st.accumulated += float(self._poly(raw))
                # signed comparison, as the reference (main_hunyuan.py:121)
                compute = not st.accumulated < self.thresh
                if compute:
                    st.accumulated = 0.0
            # kept in the incoming (model) dtype, as the reference does
            st.previous_modulated = modulated
        if compute:
            st.computed_steps += 1
        else:
            st.skipped_steps += 1
        self.decisions.append(compute)
        return compute

    def apply_residual(self, hidden, ctx=None):
        st = self.states[(self._call_count - 1) % self.cfg_streams]
        hidden = hidden + st.previous_residual
        if ctx is not None:
            if st.previous_residual_ctx is not None:
                ctx = ctx + st.previous_residual_ctx
            return hidden, ctx
        return hidden

    def record_residual_value(self, residual, residual_ctx=None):
        """Store an already-computed stack residual (residual_value)."""
        st = self.states[(self._call_count - 1) % self.cfg_streams]
        st.previous_residual = residual
        if residual_ctx is not None:
            st.previous_residual_ctx = residual_ctx

    def stats(self) -> dict:
        return {
            "skipped": sum(s.skipped_steps for s in self.states),
            "computed": sum(s.computed_steps for s in self.states),
        }
