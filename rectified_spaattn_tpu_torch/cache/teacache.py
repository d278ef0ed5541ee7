"""TeaCache — step-residual caching across diffusion steps (port of
rectified_spaattn_tpu/cache/teacache.py).

The whole transformer-stack residual (hidden_out - hidden_in) is cached; a
step is SKIPPED (residual re-applied) when the modulated input changed
little since the last computed step, as measured by an accumulated,
polynomial-rescaled relative-L1 signal (reference:
scripts/main_hunyuan.py:110-157; the CFG even/odd dual-stream variant,
scripts/main_wan21t2v.py:105-133).  The signal is computed on the device;
ONE scalar per step crosses to the host, where the sampler loop branches.

The residual is stored as bf16 (the reference's format) or, with
``residual_value(..., "int8")``, as per-token-row absmax int8 plus fp32
row scales (half the bytes); ``offload_residual`` keeps it in pinned host
memory between calls.

Schedule tracing: inside ``trace_to(path)`` every enabled TeaCache appends
one meta record at construction and one ``{call, stream, raw, compute}``
record per ``should_compute`` (``forced`` too on a replayed schedule), the
JAX package's JSON key for key; ``schedule_from_trace`` reads such a file
back as a ``forced_schedule``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.timing import span

# Polynomial rescaling coefficients for the raw rel-L1 signal
# (numpy.poly1d convention: highest power first; reference:
# main_hunyuan.py:118 and the Wan drivers).
COEFFICIENTS: dict[str, list[float]] = {
    "hunyuan-video": [7.33226126e+02, -4.01131952e+02, 6.75869174e+01,
                      -3.14987800e+00, 9.61237896e-02],
    # Wan (reference: main_wan21t2v.py:273-286, main_wan21i2v.py,
    # main_wan22ti2v.py, main_wan22t2v.py)
    "wan2.1-t2v-1.3b": [2.39676752e+03, -1.31110545e+03, 2.01331979e+02,
                        -8.29855975e+00, 1.37887774e-01],
    "wan2.1-t2v-14b": [-5784.54975374, 5449.50911966, -1811.16591783,
                       256.27178429, -13.02252404],
    "wan2.1-t2v-14b-ret": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                           5.87365115e+01, -3.15583525e-01],
    "wan2.1-i2v-480p": [-3.02331670e+02, 2.23948934e+02, -5.25463970e+01,
                        5.87348440e+00, -2.01973289e-01],
    "wan2.1-i2v-480p-ret": [2.57151496e+05, -3.54229917e+04, 1.40286849e+03,
                            -1.35890334e+01, 1.32517977e-01],
    "wan2.1-i2v-720p": [-114.36346466, 65.26524496, -18.82220707,
                        4.91518089, -0.23412683],
    "wan2.1-i2v-720p-ret": [8.10705460e+03, 2.13393892e+02, -3.72934672e+01,
                            1.66203073e+00, -4.17769401e-02],
    # CogVideoX (reference: main_cogvideox.py:20-25) and Flux
    "cogvideox1.5-5b": [-1.53880483e+03, 8.43202495e+02, -1.34363087e+02,
                        7.97131516e+00, -5.23162339e-02],
    "cogvideox1.5-5b-i2v": [-1.53880483e+03, 8.43202495e+02, -1.34363087e+02,
                            7.97131516e+00, -5.23162339e-02],
    "flux-dev": [4.98651651e+02, -2.83781631e+02, 5.58554382e+01,
                 -3.82021401e+00, 2.64230861e-01],
    "wan2.2-ti2v-5b": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                       5.87365115e+01, -3.15583525e-01],
    "wan2.2-a14b": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                    5.87365115e+01, -3.15583525e-01],
    "identity": [1.0, 0.0],
}

# The live trace list inside ``trace_to`` (None outside it).
TRACE: Optional[list] = None


@contextlib.contextmanager
def trace_to(path: Optional[str]):
    """Trace every TeaCache schedule made in the body and write the records
    to ``path`` as JSON (a no-op when ``path`` is falsy).  Yields the live
    list (None when disabled).  Contexts do not nest."""
    global TRACE
    if not path:
        yield None
        return
    if TRACE is not None:
        raise RuntimeError("trace_to contexts must not nest")
    TRACE = []
    try:
        yield TRACE
    finally:
        trace, TRACE = TRACE, None
        with open(path, "w") as f:
            json.dump(trace, f)


def schedule_from_trace(path: str) -> list:
    """The per-call compute/skip list of a trace_to JSON, for
    ``TeaCache(forced_schedule=...)`` replay."""
    with open(path) as f:
        records = json.load(f)
    return [bool(r["compute"]) for r in records if "call" in r]


def residual_value(x_out: torch.Tensor, x_in: torch.Tensor,
                   store: str = "bf16"):
    """Encode the stack residual for record_residual_value.

    ``store`` "bf16": the reference's format (main_hunyuan.py:152).
    "int8": (q int8, scale fp32 [..., 1]) with scale = max|r| over the
    last dim / 127 and q = round(r / max(scale, 1e-30)), the JAX package's
    encode (bit for bit on the same r)."""
    r = x_out - x_in
    if store == "int8":
        scale = r.abs().float().amax(dim=-1, keepdim=True) / 127.0
        q = torch.round(r.float() / torch.clamp(scale, min=1e-30))
        return q.to(torch.int8), scale
    if store != "bf16":
        raise ValueError(f"residual store must be bf16|int8, got {store!r}")
    return r.to(torch.bfloat16)


def _dequant_add(hidden: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """hidden + q * scale in fp32, returned in hidden's dtype."""
    return (hidden.float() + q.float() * scale).to(hidden.dtype)


def _to_host(res):
    """A residual (a tensor or the int8 (q, scale) pair) in pinned host
    memory where there is a GPU (one device-to-host copy each)."""
    if isinstance(res, tuple):
        return tuple(_to_host(t) for t in res)
    if res.device.type == "cpu":
        return res.clone()
    host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
    host.copy_(res)
    return host


def _to_device(res, device):
    if isinstance(res, tuple):
        return tuple(_to_device(t, device) for t in res)
    return res.to(device, non_blocking=True)


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
      offload_residual: keep previous_residual in (pinned) host memory
        between calls: one device-to-host copy per computed call, one
        host-to-device copy per skipped call, and no device memory held.
    """
    thresh: float
    num_steps: int
    coefficients: list | str = "identity"
    ret_steps: Optional[int] = None
    cutoff_steps: Optional[int] = None
    cfg_streams: int = 1
    signal_scale: float = 1.0
    forced_schedule: Optional[Sequence[bool]] = None
    offload_residual: bool = False

    def __post_init__(self):
        coeffs = (COEFFICIENTS[self.coefficients]
                  if isinstance(self.coefficients, str) else self.coefficients)
        self._poly = np.poly1d(coeffs)
        self.reset()
        if TRACE is not None and self.enabled:
            TRACE.append({"meta": {
                "thresh": self.thresh, "num_steps": self.num_steps,
                "coefficients": [float(c) for c in coeffs],
                "ret_steps": self.ret_steps,
                "cutoff_steps": self.cutoff_steps,
                "cfg_streams": self.cfg_streams,
                "signal_scale": self.signal_scale,
                "replay": self.forced_schedule is not None}})

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
        raw = None
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
                rel = rel_l1_signal(modulated, st.previous_modulated)
                with span("rsa.sync.teacache"):
                    raw = float(rel) * self.signal_scale
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
        if TRACE is not None:
            rec = {"call": cnt, "stream": cnt % self.cfg_streams,
                   "raw": raw, "compute": compute}
            if self.forced_schedule is not None:
                rec["forced"] = True
            TRACE.append(rec)
        return compute

    def apply_residual(self, hidden, ctx=None):
        st = self.states[(self._call_count - 1) % self.cfg_streams]
        res = st.previous_residual
        if self.offload_residual:
            res = _to_device(res, hidden.device)
        if isinstance(res, tuple):          # int8 encode (residual_value)
            hidden = _dequant_add(hidden, *res)
        else:
            hidden = hidden + res
        if ctx is not None:
            if st.previous_residual_ctx is not None:
                ctx = ctx + st.previous_residual_ctx
            return hidden, ctx
        return hidden

    def record_residual(self, hidden_in, hidden_out, ctx_in=None,
                        ctx_out=None):
        """Store the bf16 stack residual hidden_out - hidden_in (and the
        text stream's, when both ctx tensors are given)."""
        self.record_residual_value(
            (hidden_out - hidden_in).to(torch.bfloat16),
            (ctx_out - ctx_in).to(torch.bfloat16)
            if ctx_in is not None and ctx_out is not None else None)

    def record_residual_value(self, residual, residual_ctx=None):
        """Store an already-computed stack residual: the bf16 tensor or the
        int8 (q, scale) encode of residual_value."""
        st = self.states[(self._call_count - 1) % self.cfg_streams]
        if self.offload_residual:
            residual = _to_host(residual)
        st.previous_residual = residual
        if residual_ctx is not None:
            st.previous_residual_ctx = residual_ctx

    def stats(self) -> dict:
        return {
            "skipped": sum(s.skipped_steps for s in self.states),
            "computed": sum(s.computed_steps for s in self.states),
        }
