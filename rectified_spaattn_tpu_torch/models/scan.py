"""Scan-over-blocks execution (port of rectified_spaattn_tpu/models/scan.py).

The JAX package runs a deep uniform block stack as one ``lax.scan`` over
parameters stacked leaf-wise to [L, ...], so that XLA compiles one block
instead of L, and splits the stack into windows (``dispatch_segments``)
for a runtime that kills long dispatches.  In eager PyTorch neither reason
carries over: a loop over the stack's slices launches what the unrolled
loop launches, kernel for kernel, and windows run back to back are that
one loop.  The port keeps the execution mode so that the JAX package's
serving command lines (``--scan_blocks``, ``--dispatch_segments``) run,
with the numbers of the unrolled path: the pipelines check
``dispatch_segments`` as JAX does and run one loop whatever its value;
the window functions stay as the counterparts of JAX's.

``BlockStack`` stacks one ``nn.ModuleList`` of identical blocks leaf-wise:
every parameter and buffer (a ``QLinear``'s int8 / int4 buffers, a
tp-sharded block's slices) becomes one [L, ...] tensor in the leaves' own
memory, made leaf by leaf, and each block's leaf is rebound to the view
``stacked[i]`` as soon as its stack exists.  The model then holds one copy
of its weights, and block ``i`` runs as itself on the views
``stacked[i]``.  Quantize and shard before stacking: a model changed after
stacking is stacked again by the next pipeline that takes it
(``stack_model_blocks``).

``stack_block_params`` / ``unstack_block_params`` do the same on flat
state-dict trees keyed like the port's modules (``dual_blocks.0.norm1
.linear.weight`` ...): stacking stays in the leaves' memory space (host
tensors in, host tensors out) and takes the blocks' leaves out of the
tree one leaf at a time; unstacking returns views.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .layers import AttnFn


def _block_keys(tree, prefix: str, i: int) -> dict:
    """{block-relative name: key} of block ``i`` of a flat tree."""
    head = f"{prefix}{i}."
    return {k[len(head):]: k for k in tree if k.startswith(head)}


def _check_same(name: str, tensors) -> None:
    t0 = tensors[0]
    for t in tensors[1:]:
        if t.shape != t0.shape or t.dtype != t0.dtype \
                or t.device != t0.device:
            raise ValueError(f"{name}: blocks differ ({tuple(t0.shape)} "
                             f"{t0.dtype} {t0.device} against "
                             f"{tuple(t.shape)} {t.dtype} {t.device})")


def stack_block_params(tree: dict, prefix: str, n: int):
    """Split ``{prefix}0.*`` .. ``{prefix}{n-1}.*`` out of a flat state
    dict and stack them leaf-wise to [n, ...].  Returns (rest, stacked):
    ``stacked`` is keyed by the block-relative names; ``rest`` is ``tree``
    itself, whose block entries are removed as each leaf's stack is made,
    so a tree on the card never holds two copies of a block stack."""
    keys = [_block_keys(tree, prefix, i) for i in range(n)]
    missing = [f"{prefix}{i}" for i, k in enumerate(keys) if not k]
    if missing:
        raise KeyError(f"blocks missing from the tree: {missing[:3]}")
    names = sorted(keys[0])
    for i, k in enumerate(keys[1:], 1):
        if sorted(k) != names:
            raise KeyError(f"{prefix}{i} holds other leaves than {prefix}0: "
                           f"{sorted(set(k) ^ set(names))[:4]}")
    stacked = {}
    for name in names:
        leaves = [tree[k[name]] for k in keys]
        _check_same(f"{prefix}*.{name}", leaves)
        stacked[name] = torch.stack(leaves)
        del leaves
        for k in keys:
            del tree[k[name]]
    return tree, stacked


def unstack_block_params(stacked: dict, prefix: str) -> dict:
    """Inverse of ``stack_block_params``: ``{prefix}{i}.{name}`` -> the
    view ``stacked[name][i]`` (no copy)."""
    n = next(iter(stacked.values())).shape[0]
    return {f"{prefix}{i}.{name}": v[i]
            for i in range(n) for name, v in stacked.items()}


def _leaves(module: nn.Module) -> dict:
    """Every parameter and buffer of ``module`` by dotted name (a
    quantized QLinear's ``weight`` is None, so no leaf)."""
    out = {**dict(module.named_parameters(remove_duplicate=False)),
           **dict(module.named_buffers(remove_duplicate=False))}
    if len({id(t) for t in out.values()}) != len(out):
        raise ValueError("tied parameters cannot be stacked")
    return out


def _rebind(module: nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Make ``tensor`` the leaf ``name`` of ``module`` (a parameter stays a
    parameter, a buffer a buffer)."""
    mod_name, _, leaf = name.rpartition(".")
    mod = module.get_submodule(mod_name) if mod_name else module
    if leaf in mod._parameters:
        mod._parameters[leaf] = nn.Parameter(tensor, requires_grad=False)
    else:
        mod._buffers[leaf] = tensor


class BlockStack:
    """One ``nn.ModuleList`` of identical blocks stacked leaf-wise (see the
    module docstring).  ``blocks[i]`` runs block ``i`` on its views;
    ``params`` holds the [L, ...] stacks by block-relative name;
    ``prefix`` is the list's name in its model with the dot
    (``"dual_blocks."``)."""

    def __init__(self, blocks: nn.ModuleList, prefix: str = ""):
        self.blocks, self.prefix, self.params = blocks, prefix, {}
        if not len(blocks):
            return
        leaves = [_leaves(b) for b in blocks]
        names = sorted(leaves[0])
        for i, lv in enumerate(leaves[1:], 1):
            if sorted(lv) != names:
                raise ValueError(f"{prefix}{i} holds other leaves than "
                                 f"{prefix}0: "
                                 f"{sorted(set(lv) ^ set(names))[:4]}")
        with torch.no_grad():
            for name in names:
                _check_same(f"{prefix}*.{name}", [lv[name] for lv in leaves])
                st = torch.stack([lv[name].detach() for lv in leaves])
                for i, (blk, lv) in enumerate(zip(blocks, leaves)):
                    _rebind(blk, name, st[i])
                    del lv[name]       # the block's own copy can go now
                self.params[name] = st

    def __len__(self) -> int:
        return len(self.blocks)

    def is_bound(self) -> bool:
        """Whether every block's leaves are still the views of the stack."""
        for i, blk in enumerate(self.blocks):
            lv = _leaves(blk)
            if sorted(lv) != sorted(self.params):
                return False
            for name, st in self.params.items():
                t = lv[name]
                if (t.data_ptr() != st[i].data_ptr() or t.shape != st.shape[1:]
                        or t.dtype != st.dtype or t.device != st.device):
                    return False
        return True

    def state_dict(self) -> dict:
        """The stacks keyed as the model's state dict keys its lists:
        ``{prefix}{name}`` (no block index)."""
        return {self.prefix + n: st for n, st in self.params.items()}

    def bind(self, stacked: dict) -> None:
        """Take ``stacked`` ({name: [L, ...]}) as the stack: each block's
        leaves become its views.  Every leaf of block 0 must be given and
        nothing else, at its shapes and dtypes (block 0 may be on meta)."""
        want = _leaves(self.blocks[0])
        missing = sorted(set(want) - set(stacked))
        extra = sorted(set(stacked) - set(want))
        if missing or extra:
            raise KeyError(f"stacked tree does not match the blocks: "
                           f"missing {missing[:4]}, unconsumed {extra[:4]}")
        for name, st in stacked.items():
            w = want[name]
            if st.shape != (len(self), *w.shape) or st.dtype != w.dtype:
                raise ValueError(f"{name}: {tuple(st.shape)} {st.dtype}, "
                                 f"want {(len(self), *w.shape)} {w.dtype}")
        for name, st in stacked.items():
            for i, blk in enumerate(self.blocks):
                _rebind(blk, name, st[i])
        self.params = dict(stacked)

    def release(self) -> None:
        """Drop the stacks' memory (the blocks must let go of their views
        too, e.g. ``model.to("meta")``)."""
        self.params = {n: st.to("meta") for n, st in self.params.items()}


def stack_model_blocks(model: nn.Module, *names: str) -> tuple:
    """The BlockStacks of ``model``'s block lists ``names`` (attribute
    names), made once per model: a pipeline that takes a model another
    pipeline has stacked (Flux's two stages share one trunk) reuses the
    stacks while the blocks are still their views."""
    stacks = model.__dict__.setdefault("_block_stacks", {})
    out = []
    for name in names:
        st = stacks.get(name)
        blocks = getattr(model, name)
        if st is None or st.blocks is not blocks or not st.is_bound():
            st = stacks[name] = BlockStack(blocks, name + ".")
        out.append(st)
    return tuple(out)


def model_stacks(model: nn.Module) -> dict:
    """{list name: BlockStack} that ``stack_model_blocks`` made for
    ``model`` (empty if none)."""
    return model.__dict__.get("_block_stacks", {})


def stacked_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with each stacked list's per-block entries
    replaced by its stacks (``BlockStack.state_dict``): one tree's bytes,
    each stack once."""
    stacks = model_stacks(model)
    heads = tuple(st.prefix for st in stacks.values())
    out = {k: v for k, v in model.state_dict().items()
           if not k.startswith(heads)}
    for st in stacks.values():
        out.update(st.state_dict())
    return out


def load_stacked_state_dict(model: nn.Module, sd: dict) -> None:
    """Inverse of ``stacked_state_dict``, by assignment (no copy): the
    model's other leaves become ``sd``'s tensors, each stack is bound and
    its blocks' leaves become its views.  Strict: every key is consumed
    and every leaf filled."""
    stacks = model_stacks(model)
    per = {name: {} for name in stacks}
    flat = {}
    for k, v in sd.items():
        name = next((n for n, st in stacks.items()
                     if k.startswith(st.prefix)), None)
        if name is None:
            flat[k] = v
        else:
            per[name][k[len(stacks[name].prefix):]] = v
    heads = tuple(st.prefix for st in stacks.values())
    res = model.load_state_dict(flat, strict=False, assign=True)
    missing = [k for k in res.missing_keys if not k.startswith(heads)]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:8]}, unconsumed {res.unexpected_keys[:8]}")
    for name, st in stacks.items():
        st.bind(per[name])


def release_model_stacks(model: nn.Module) -> None:
    """``release`` every stack of ``model``."""
    for st in model_stacks(model).values():
        st.release()


# ------------------------------------------------------- the scan bodies ---

def hunyuan_run_blocks_scan(cfg, dual_stack: BlockStack,
                            single_stack: BlockStack, x, ctx, temb, rope,
                            attn_fn: AttnFn, temb_alt=None, alt_mask=None):
    """HunyuanVideoDiT.run_blocks over the stacks (reference hot loop:
    scripts/main_hunyuan.py:134-157).  One loop in one frame, so each
    block's input is freed as the unrolled loop frees it."""
    for n, stack in ((cfg.num_dual_blocks, dual_stack),
                     (cfg.num_single_blocks, single_stack)):
        for i in range(n):
            x, ctx = stack.blocks[i](x, ctx, temb, rope, attn_fn,
                                     temb_alt, alt_mask)
    return x, ctx


def hunyuan_run_phase_scan(cfg, stack: BlockStack, phase: str, x, ctx, temb,
                           rope, attn_fn: AttnFn, win_start: int,
                           win_size: int, temb_alt=None, alt_mask=None):
    """A window ``[win_start, win_start + win_size)`` of one Hunyuan phase
    ("dual" or "single") over the whole stack: each block's slices are
    taken as it runs, never the window's up front (JAX scan.py:93-96)."""
    if phase not in ("dual", "single"):
        raise ValueError(f"phase {phase!r}")
    for i in range(win_start, win_start + win_size):
        x, ctx = stack.blocks[i](x, ctx, temb, rope, attn_fn, temb_alt,
                                 alt_mask)
    return x, ctx


def wan_run_blocks_scan(cfg, stack: BlockStack, x, ctx, ctx_img, temb6, rope,
                        segments, cross_attn_fn: AttnFn):
    """WanDiT.run_blocks over the stack.  ``segments``: [(start, end,
    self_attn_fn), ...] covering [0, n) in order, the reference's
    per-layer warm gates (rectified_wan21_attn.py:467)."""
    for start, end, fn in segments:
        for i in range(start, end):
            x = stack.blocks[i](x, ctx, temb6, rope, fn, cross_attn_fn,
                                ctx_img=ctx_img)
    return x


def wan_run_window_scan(cfg, stack: BlockStack, x, ctx, ctx_img, temb6, rope,
                        attn_fn: AttnFn, cross_attn_fn: AttnFn,
                        win_start: int, win_size: int):
    """A window of the Wan stack with one self-attention function."""
    for i in range(win_start, win_start + win_size):
        x = stack.blocks[i](x, ctx, temb6, rope, attn_fn, cross_attn_fn,
                            ctx_img=ctx_img)
    return x


def flux_run_blocks_scan(cfg, dual_stack: BlockStack,
                         single_stack: BlockStack, x, ctx, temb, rope,
                         dual_segments, single_segments, cn_dual=None,
                         cn_single=None):
    """FluxDiT.run_blocks over the stacks.  ``*_segments``: [(start, end,
    attn_fn), ...] covering each stack, the reference's sparse layer gate
    (rectified_flux_attn.py:493).  ``cn_dual`` / ``cn_single``: the RAW
    ControlNet sample lists; block ``i`` of a stack of L adds sample
    min(i // ceil(L / N), N - 1) (reference main_upflux.py:163-172), so
    no list of L residuals is built."""
    for stack, segments, cn, n_blocks in (
            (dual_stack, dual_segments, cn_dual, cfg.num_dual_blocks),
            (single_stack, single_segments, cn_single,
             cfg.num_single_blocks)):
        interval = math.ceil(n_blocks / len(cn)) if cn else 1
        for start, end, fn in segments if n_blocks else ():
            for i in range(start, end):
                x, ctx = stack.blocks[i](x, ctx, temb, rope, fn)
                if cn:
                    x = x + cn[min(i // interval, len(cn) - 1)].to(x.dtype)
    return x, ctx


def cog_run_blocks_scan(cfg, stack: BlockStack, x, ctx, temb, rope,
                        attn_fn: AttnFn):
    """CogVideoXDiT.run_blocks over the stack (CogVideoX gates sparsity by
    call, not layer, so one scan covers the whole stack)."""
    for i in range(len(stack)):
        x, ctx = stack.blocks[i](x, ctx, temb, rope, attn_fn)
    return x, ctx


def gate_segments(n: int, fn_of_index) -> list:
    """Collapse a per-layer attention-function assignment into contiguous
    (start, end, fn) segments; equal means the same object."""
    segs = []
    for i in range(n):
        fn = fn_of_index(i)
        if segs and segs[-1][2] is fn:
            segs[-1] = (segs[-1][0], i + 1, fn)
        else:
            segs.append((i, i + 1, fn))
    return segs


def hunyuan_teacache_signal_scan(cfg, dual_stack: BlockStack, x, temb):
    """Block 0's norm1 modulated input from the stack (the unrolled path's
    HunyuanVideoDiT.teacache_signal; reference scripts/main_hunyuan.py:113)."""
    if not cfg.num_dual_blocks:
        return x + temb[:, None]
    return dual_stack.blocks[0].norm1(x, temb)[0]
