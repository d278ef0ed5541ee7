"""Weight-only quantization, int8 and packed int4 (port of
rectified_spaattn_tpu/models/quant.py).

``QLinear`` is the port's ``QDense``: an ``nn.Linear`` drop-in that holds
one of three layouts, in the torch orientation ([out, in]) of the JAX
package's [in, out] kernels:

  weight [out, in]                               dense, with Flax's dtype
                                                 promotion of input and
                                                 parameters
  weight_q int8 [out, in] + scale fp32 [out]     per-output-channel int8;
                                                 the scale multiplies the
                                                 fp32 accumulator
  weight_q4 uint8 [out, in // 2]                 offset-binary int4, two
    + scale fp32 [groups, out]                   input rows per byte (low
                                                 nibble first), one scale
                                                 per group of input rows;
                                                 dequantized to the input
                                                 dtype right before the dot

int8 on the GPU: a bf16 / fp16 input meets the int8 weights as a bf16 /
fp16 copy (int8 values are exact in both), and ``torch.mm(..., out_dtype=
torch.float32)`` keeps cuBLAS's fp32 accumulator, so the scale lands on it
before the one rounding to the input dtype, as in the JAX package.  The
fp32 product is taken in row tiles of at most 256 MB.  On the CPU the
product runs in fp32.

``quantize_model`` converts a model's QLinear layers in place, one layer
at a time, so a model never holds a second full copy of its weights;
``quantize_state_dict`` does the same to a state dict.  Both follow
``quantize_params``' rules: a weight is quantized when it has at least
``min_size`` elements (1 << 20), an even input width and a name that
contains none of ``skip``; int8 scales are absmax / 127 per output channel
(absmax floored at 1e-12), int4 scales absmax / 7 per group of
``group_size`` input rows.  Quantized tensors are buffers that follow the
module's device but never its dtype (``model.to(torch.bfloat16)`` keeps
them int8 / uint8 / fp32).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

_QUANT_BUFFERS = ("weight_q", "weight_q4", "scale")
_FP32_TILE_BYTES = 256 << 20


def unpack_int4(packed: torch.Tensor, scale: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """[out, in // 2] offset-binary nibbles + [groups, out] scales ->
    [out, in] in ``dtype`` (the product taken in fp32)."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
    out, din = q.shape
    groups = scale.shape[0]
    w = (q.reshape(out, groups, din // groups).float()
         * scale.float().t()[:, :, None])
    return w.reshape(out, din).to(dtype)


def _quantize_weight(w: torch.Tensor, bits: int, group_size: int) -> dict:
    """One [out, in] weight -> {"weight_q", "scale"} or {"weight_q4",
    "scale"}, in fp32 arithmetic on the weight's device."""
    w = w.float()
    if bits == 8:
        scale = torch.clamp(w.abs().amax(dim=1), min=1e-12) / 127.0
        q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
        return {"weight_q": q.to(torch.int8), "scale": scale}
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out, din = w.shape
    g = min(group_size, din)
    if din % g or din % 2:
        raise ValueError(f"in-dim {din} not divisible by group {g} / 2")
    wg = w.reshape(out, din // g, g)
    scale = torch.clamp(wg.abs().amax(dim=-1), min=1e-12) / 7.0  # [out, G]
    q = (torch.clamp(torch.round(wg / scale[..., None]), -8, 7) + 8).to(
        torch.int32).reshape(out, din)
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).to(torch.uint8)
    return {"weight_q4": packed, "scale": scale.t().contiguous()}


def dequantize_kernel(node) -> torch.Tensor:
    """The [out, in] fp32 weight a quantized layer (a QLinear or a mapping
    with its ``weight_q`` / ``weight_q4`` and ``scale``) represents (tests
    and debugging; the serving path never materializes it)."""
    get = node.get if isinstance(node, Mapping) else (
        lambda n: getattr(node, n, None))
    if get("weight_q") is not None:
        return get("weight_q").float() * get("scale").float()[:, None]
    return unpack_int4(get("weight_q4"), get("scale"), torch.float32)


class QLinear(nn.Linear):
    """``nn.Linear`` drop-in that can hold weight-only-quantized weights
    (the JAX package's ``QDense``); see the module docstring."""

    @property
    def layout(self) -> str:
        if self.weight is not None:
            return "dense"
        return "int8" if self._buffers.get("weight_q") is not None else "int4"

    def set_quantized(self, tensors: Mapping):
        """Replace the dense weight by ``{"weight_q" | "weight_q4",
        "scale"}`` tensors (their device and dtype as given)."""
        self.register_parameter("weight", None)
        for name in _QUANT_BUFFERS:
            self._buffers.pop(name, None)
        for name, t in tensors.items():
            if name not in _QUANT_BUFFERS:
                raise KeyError(name)
            self.register_buffer(name, t)
        return self

    def quantize_(self, bits: int = 8, group_size: int = 128):
        """Quantize this layer's dense weight in place."""
        return self.set_quantized(_quantize_weight(self.weight.detach(), bits,
                                                   group_size))

    def _apply(self, fn, recurse=True):
        # quantized buffers follow the module's device, never its dtype
        held = {n: self._buffers.pop(n) for n in _QUANT_BUFFERS
                if self._buffers.get(n) is not None}
        super()._apply(fn, recurse)
        for name, t in held.items():
            dev = fn(torch.empty(0, dtype=torch.int8, device=t.device)).device
            self._buffers[name] = t.to(dev)
        return self

    def _bias(self, dtype):
        return None if self.bias is None else self.bias.to(dtype)

    def forward(self, x):
        layout = self.layout
        if layout == "dense":
            dt = torch.promote_types(x.dtype, self.weight.dtype)
            return F.linear(x.to(dt), self.weight.to(dt), self._bias(dt))
        if layout == "int4":
            w = unpack_int4(self.weight_q4, self.scale, x.dtype)
            return F.linear(x, w, self._bias(x.dtype))
        y = self._int8_scaled(x)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def _int8_scaled(self, x):
        """(x @ weight_q^T) * scale with the scale on the fp32 accumulator,
        rounded once to x.dtype."""
        if not (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)):
            y = F.linear(x.float(), self.weight_q.float())
            return (y * self.scale).to(x.dtype)
        wt = self.weight_q.to(x.dtype).t()
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.empty((x2.shape[0], wt.shape[1]), dtype=x.dtype,
                        device=x.device)
        rows = max(1, _FP32_TILE_BYTES // (4 * wt.shape[1]))
        for r0 in range(0, x2.shape[0], rows):
            acc = torch.mm(x2[r0:r0 + rows], wt, torch.float32)
            y[r0:r0 + rows] = (acc * self.scale).to(x.dtype)
        return y.reshape(*x.shape[:-1], wt.shape[1])


def _selected(name: str, w, min_size: int, skip) -> bool:
    return (w is not None and w.ndim == 2 and w.numel() >= min_size
            and w.shape[1] % 2 == 0 and not any(s in name for s in skip))


@torch.no_grad()
def quantize_model(model: nn.Module, bits: int = 8, group_size: int = 128,
                   min_size: int = 1 << 20, skip: tuple = ()) -> nn.Module:
    """Quantize, in place and one layer at a time, every dense QLinear whose
    weight passes the rules; ``skip`` holds substrings of module names
    (e.g. ``("proj_out",)``).  Returns the model."""
    for name, mod in model.named_modules():
        if isinstance(mod, QLinear) and mod.layout == "dense" and _selected(
                name, mod.weight, min_size, skip):
            mod.quantize_(bits, group_size)
    return model


@torch.no_grad()
def quantize_state_dict(sd: Mapping, bits: int = 8, group_size: int = 128,
                        min_size: int = 1 << 20, skip: tuple = ()) -> dict:
    """The state-dict form of ``quantize_model``: every 2-D ``*.weight``
    that passes the rules becomes ``*.weight_q`` / ``*.weight_q4`` and
    ``*.scale``; the rest is passed through."""
    out = {}
    for key, t in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "weight" and _selected(prefix, t, min_size, skip):
            for n, v in _quantize_weight(t, bits, group_size).items():
                out[f"{prefix}.{n}" if prefix else n] = v
        else:
            out[key] = t
    return out


def adopt_layout(model: nn.Module, sd: Mapping) -> nn.Module:
    """Switch each QLinear to the layout ``sd`` holds for it (empty
    tensors of the right shapes), so that ``load_state_dict(sd,
    strict=True)`` fills it."""
    for name, mod in model.named_modules():
        if not isinstance(mod, QLinear):
            continue
        for q in ("weight_q", "weight_q4"):
            key = f"{name}.{q}" if name else q
            if key in sd:
                scale = sd[f"{name}.scale" if name else "scale"]
                dev = next(t.device for t in (mod.weight, mod.bias,
                                              mod._buffers.get("scale"))
                           if t is not None)
                mod.set_quantized({
                    q: torch.empty(sd[key].shape, dtype=sd[key].dtype,
                                   device=dev),
                    "scale": torch.empty(scale.shape, dtype=torch.float32,
                                         device=dev)})
    return model


def quantized_nbytes(obj) -> int:
    """Total bytes of a model's parameters and buffers, or of a state
    dict's tensors."""
    if isinstance(obj, nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    else:
        tensors = list(obj.values())
    return sum(t.numel() * t.element_size() for t in tensors)
