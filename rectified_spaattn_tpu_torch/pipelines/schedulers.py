"""Flow-match Euler sampler (port of the HunyuanVideo part of
rectified_spaattn_tpu/pipelines/schedulers.py): a host-side state machine
whose per-step math is one tensor expression."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def flow_shift_timesteps(num_steps: int, shift: float = 1.0) -> np.ndarray:
    """sigma_i in (1, 0], shifted: sigma' = s*sigma / (1 + (s-1)*sigma)."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
    if shift != 1.0:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return sigmas


@dataclasses.dataclass
class FlowMatchEulerScheduler:
    """First-order Euler over the rectified-flow ODE:
    x_{t-1} = x_t + (sigma_{t-1} - sigma_t) * v_pred."""
    num_steps: int
    shift: float = 7.0

    def __post_init__(self):
        self.sigmas = np.append(
            flow_shift_timesteps(self.num_steps, self.shift), 0.0)

    @property
    def timesteps(self) -> np.ndarray:
        """Model-facing timesteps in [0, 1000)."""
        return self.sigmas[:-1] * 1000.0

    def step(self, model_out, sample, i: int):
        # the JAX step multiplies by a numpy float64 scalar, which promotes
        # a bf16 model output to fp32 before the update: do the same
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        dtype = torch.promote_types(
            torch.promote_types(sample.dtype, model_out.dtype), torch.float32)
        return sample.to(dtype) + model_out.to(dtype) * dt

