"""Samplers (port of the flow-match part of
rectified_spaattn_tpu/pipelines/schedulers.py): host-side state machines
whose per-step math is a few tensor expressions.

  * flow-match Euler (HunyuanVideo),
  * UniPC multistep for flow matching (Wan2.1, flow_shift 5.0; reference:
    scripts/main_wan21t2v.py:236-241).

Both update in fp32: the JAX steps multiply by numpy float64 scalars, which
promote a bf16 model output to fp32 before the update.
"""

from __future__ import annotations

import dataclasses
import math

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
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        dtype = _update_dtype(model_out, sample)
        return sample.to(dtype) + model_out.to(dtype) * dt


def _update_dtype(model_out, sample) -> torch.dtype:
    return torch.promote_types(
        torch.promote_types(sample.dtype, model_out.dtype), torch.float32)


@dataclasses.dataclass
class UniPCScheduler:
    """UniPC multistep (order 2) for flow matching, the Wan2.1 sampler
    (diffusers UniPCMultistepScheduler with flow_shift and flow
    prediction), the B(h)=h "bh2" variant: the corrector refines the
    previous prediction with this step's x0, then the predictor advances."""
    num_steps: int
    shift: float = 5.0
    order: int = 2

    def __post_init__(self):
        self.sigmas = np.append(
            flow_shift_timesteps(self.num_steps, self.shift), 0.0)
        self._model_outputs: list = [None] * self.order
        self._lower_order_nums = 0
        self._last_sample = None

    @property
    def timesteps(self) -> np.ndarray:
        return self.sigmas[:-1] * 1000.0

    @staticmethod
    def _alpha_sigma(sigma):
        # flow matching: alpha_t = 1 - sigma, sigma_t = sigma
        return 1.0 - sigma, sigma

    def _lambda(self, sigma):
        alpha_t, sigma_t = self._alpha_sigma(sigma)
        return math.log(max(alpha_t, 1e-12)) - math.log(max(sigma_t, 1e-12))

    @staticmethod
    def _coeffs(hh):
        """(h_phi_1, b1, b2) of the bh2 data-prediction branch."""
        h_phi_1 = math.expm1(hh)
        h_phi_2 = h_phi_1 / hh - 1.0
        h_phi_3 = h_phi_2 / hh - 0.5
        return h_phi_1, h_phi_2 / hh, h_phi_3 * 2.0 / hh

    def step(self, model_out, sample, i: int):
        dtype = _update_dtype(model_out, sample)
        model_out, sample = model_out.to(dtype), sample.to(dtype)
        # flow prediction -> x0 prediction: x0 = x_t - sigma * v
        x0 = sample - float(self.sigmas[i]) * model_out
        if self._last_sample is not None and self._lower_order_nums >= 1:
            sample = self._unic(x0, self._last_sample, i)
        self._model_outputs = self._model_outputs[1:] + [x0]
        order = min(self.order, self._lower_order_nums + 1,
                    self.num_steps - i)
        self._last_sample = sample
        out = self._unip(sample, i, order)
        self._lower_order_nums = min(self._lower_order_nums + 1, self.order)
        return out

    def _unip(self, sample, i, order):
        s0, st = self.sigmas[i], self.sigmas[i + 1]
        h = self._lambda(st) - self._lambda(s0)
        a_t, sg_t = self._alpha_sigma(st)
        hh = -h
        h_phi_1, b1, _ = self._coeffs(hh)
        x0_0 = self._model_outputs[-1]
        x_t = float(sg_t / s0) * sample - float(a_t * h_phi_1) * x0_0
        if order >= 2 and self._model_outputs[-2] is not None:
            rk = (self._lambda(self.sigmas[i - 1]) - self._lambda(s0)) / h
            d1 = (self._model_outputs[-2] - x0_0) / rk
            # order-2 predictor: rho solves the 1x1 system [1][rho] = [b1]
            x_t = x_t - float(a_t * hh * b1) * d1
        return x_t

    def _unic(self, x0_new, last_sample, i):
        s0, st = self.sigmas[i - 1], self.sigmas[i]
        h = self._lambda(st) - self._lambda(s0)
        a_t, sg_t = self._alpha_sigma(st)
        hh = -h
        h_phi_1, b1, b2 = self._coeffs(hh)
        x0_0 = self._model_outputs[-1]
        d1_t = x0_new - x0_0
        x_t_ = float(sg_t / s0) * last_sample - float(a_t * h_phi_1) * x0_0
        if self._lower_order_nums >= 2 and self._model_outputs[-2] is not None:
            rk = (self._lambda(self.sigmas[i - 2]) - self._lambda(s0)) / h
            d1 = (self._model_outputs[-2] - x0_0) / rk
            # order-2 corrector: [[1,1],[rk,1]] [rho1,rho2] = [b1,b2]
            rho1 = (b1 - b2) / (1.0 - rk)
            rho2 = b1 - rho1
            corr = rho1 * d1 + rho2 * d1_t
        else:
            corr = 0.5 * d1_t      # order-1 corrector
        return x_t_ - float(a_t * hh) * corr

