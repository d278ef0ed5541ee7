"""Samplers (port of rectified_spaattn_tpu/pipelines/schedulers.py):
host-side state machines whose per-step math is a few tensor expressions.

  * flow-match Euler (HunyuanVideo; Flux with its resolution-dependent
    mu shift),
  * UniPC multistep for flow matching (Wan2.1, flow_shift 5.0; reference:
    scripts/main_wan21t2v.py:236-241),
  * DDIM over the zero-terminal-SNR CogVideoX betas with v-prediction,
    and CogVideoX's dynamic guidance scale.

All update in fp32: the JAX steps multiply by numpy float64 scalars, which
promote a bf16 model output to fp32 before the update.  The DDIM alpha
tables stay numpy float64, as in JAX.
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


def flux_mu_shift(seq_len: int, base_len: int = 256, max_len: int = 4096,
                  base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """Flux's resolution-dependent exponential shift parameter: linear in
    the token count, extrapolated past ``max_len`` as diffusers'
    ``calculate_shift`` does (65,536 tokens give mu = 11.55)."""
    m = (max_shift - base_shift) / (max_len - base_len)
    b = base_shift - m * base_len
    return seq_len * m + b


@dataclasses.dataclass
class FlowMatchEulerScheduler:
    """First-order Euler over the rectified-flow ODE:
    x_{t-1} = x_t + (sigma_{t-1} - sigma_t) * v_pred.  ``use_mu``: Flux's
    exponential shift sigma' = e^mu / (e^mu + 1/sigma - 1) in place of
    ``shift``."""
    num_steps: int
    shift: float = 7.0
    use_mu: bool = False
    mu: float = 0.0

    def __post_init__(self):
        if self.use_mu:
            sigmas = np.linspace(1.0, 1.0 / self.num_steps, self.num_steps)
            emu = math.exp(self.mu)
            sigmas = emu / (emu + (1.0 / sigmas - 1.0))
        else:
            sigmas = flow_shift_timesteps(self.num_steps, self.shift)
        self.sigmas = np.append(sigmas, 0.0)

    @property
    def timesteps(self) -> np.ndarray:
        """Model-facing timesteps in [0, 1000)."""
        return self.sigmas[:-1] * 1000.0

    def step(self, model_out, sample, i: int):
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        dtype = _update_dtype(model_out, sample)
        return sample.to(dtype) + model_out.to(dtype) * dt

    def scale_noise(self, sample, noise, i: int):
        """The sample noised to sigma_i: (1 - sigma_i) * sample + sigma_i
        * noise."""
        s = float(self.sigmas[i])
        dtype = _update_dtype(noise, sample)
        return (1.0 - s) * sample.to(dtype) + s * noise.to(dtype)


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



def _rescale_zero_terminal_snr(alphas_cum: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR beta rescale (Lin et al.; diffusers
    CogVideoXDDIMScheduler.rescale_zero_terminal_snr): shift/scale
    sqrt(alpha_bar) so the last timestep has alpha_bar exactly 0."""
    ab_sqrt = np.sqrt(alphas_cum)
    ab0, abT = ab_sqrt[0], ab_sqrt[-1]
    ab_sqrt = (ab_sqrt - abT) * ab0 / (ab0 - abT)
    return ab_sqrt ** 2


@dataclasses.dataclass
class CogVideoXDDIMScheduler:
    """DDIM (eta=0) over the CogVideoX scaled-linear betas, matching the
    checkpoint's scheduler config (THUDM/CogVideoX1.5-5B
    scheduler_config.json: trailing timestep spacing,
    rescale_betas_zero_snr, set_alpha_to_one, snr_shift_scale 1.0,
    v_prediction; reference script: main_cogvideox.py:274-288)."""
    num_steps: int
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 1.0    # CogVideoX 1.5 uses 1.0
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"

    def __post_init__(self):
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps) ** 2
        alphas_cum = np.cumprod(1.0 - betas)
        if self.snr_shift_scale != 1.0:
            alphas_cum = alphas_cum / (
                self.snr_shift_scale + (1 - self.snr_shift_scale) * alphas_cum)
        if self.rescale_betas_zero_snr:
            alphas_cum = _rescale_zero_terminal_snr(alphas_cum)
        self.alphas_cum = alphas_cum
        self.final_alpha_cum = 1.0     # set_alpha_to_one
        if self.timestep_spacing == "trailing":
            ratio = self.num_train_timesteps / self.num_steps
            self._timesteps = np.round(np.arange(
                self.num_train_timesteps, 0, -ratio)).astype(np.int64) - 1
        else:  # leading
            step = self.num_train_timesteps // self.num_steps
            self._timesteps = (np.arange(self.num_steps) * step)[::-1].copy()

    @property
    def timesteps(self) -> np.ndarray:
        return self._timesteps.astype(np.float32)

    def step(self, model_out, sample, i: int):
        dtype = _update_dtype(model_out, sample)
        model_out, sample = model_out.to(dtype), sample.to(dtype)
        t = int(self._timesteps[i])
        prev_t = t - self.num_train_timesteps // self.num_steps
        a_t = self.alphas_cum[t]
        a_prev = (self.alphas_cum[prev_t] if prev_t >= 0
                  else self.final_alpha_cum)
        # v-prediction (CogVideoX): x0 = sqrt(a) x - sqrt(1-a) v
        x0 = float(a_t ** 0.5) * sample - float((1 - a_t) ** 0.5) * model_out
        eps = float(a_t ** 0.5) * model_out + float((1 - a_t) ** 0.5) * sample
        return float(a_prev ** 0.5) * x0 + float((1 - a_prev) ** 0.5) * eps


def dynamic_cfg_scale(base_scale: float, timestep: float,
                      num_steps: int) -> float:
    """CogVideoX dynamic guidance, diffusers' pipeline_cogvideox.py
    use_dynamic_cfg expression: keyed on the RAW scheduler timestep
    (0..999), not the step index:
    1 + g * (1 - cos(pi * ((steps - t)/steps)^5)) / 2."""
    return 1.0 + base_scale * (
        (1.0 - math.cos(math.pi * (
            (num_steps - float(timestep)) / num_steps) ** 5.0)) / 2.0)
