"""Per-rank bodies of the multi-process cases of tests/test_torch_parallel.py
and tests/test_torch_eval.py.

Each is spawned with torch.multiprocessing, one process per rank, on gloo
with a ``file://`` rendezvous under the test's tmp_path (no TCP port).
This module imports no JAX: the test computes the JAX references itself and
hands inputs over, and takes results back, as files in that directory."""

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist


def _init(rank: int, world: int, tmp: str):
    torch.set_num_threads(1)
    from rectified_spaattn_tpu_torch.parallel import init_distributed
    init_distributed("cpu", init_method=f"file://{tmp}/rendezvous",
                     world_size=world, rank=rank,
                     timeout=datetime.timedelta(seconds=180))


def _load(tmp: str, name: str):
    return torch.load(os.path.join(tmp, name), weights_only=False)


def ring_worker(rank: int, world: int, tmp: str):
    """Each case of ring_in.pt through the ring on gloo (global inputs, as
    every rank is given them); writes ring_out_<rank>.pt."""
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.attention import (
        ring_rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.sparse import SparseConfig
    mesh = make_mesh(dp=1, tp=1, sp=world)
    out = {}
    for name, c in _load(tmp, "ring_in.pt").items():
        kw = {n: c[n] for n in ("q_text", "k_text", "v_text", "text_len_rt",
                                "kv_packed") if n in c}
        k, v = c["k"], c["v"]
        if "kv_packed" in c:
            d = c["q"].shape[-1]
            k, v = c["kv_packed"][..., :d], c["kv_packed"][..., d:]
        out[name] = ring_rectified_sparse_attention(
            mesh, c["q"], k, v, SparseConfig(**c["cfg"]), c["nbr"], **kw)
    torch.save(out, os.path.join(tmp, f"ring_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _model(kind: str, sd: dict):
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, WanConfig, WanDiT, quant)
    if kind == "hunyuan_i2v":
        model = HunyuanVideoDiT(dataclasses.replace(
            HunyuanVideoConfig.tiny(), image_condition_type="token_replace"))
    else:
        model = (HunyuanVideoDiT(HunyuanVideoConfig.tiny())
                 if kind == "hunyuan" else WanDiT(WanConfig.tiny()))
    quant.adopt_layout(model, sd)
    model.load_state_dict(sd)
    return model


def tp_worker(rank: int, world: int, tmp: str):
    """At tp = ``world``: head-parallel attention (global in / out) and its
    refusal of a head count the group does not divide, each pipeline case
    of tp_in.pt, and the CLI with ``--tp``; writes tp_out_<rank>.pt."""
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.attention import (
        head_parallel_rectified_attention)
    from rectified_spaattn_tpu_torch.cli.generate import main
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.pipelines import (HunyuanVideoPipeline,
                                                       WanPipeline)
    from rectified_spaattn_tpu_torch.sparse import SparseConfig
    mesh = make_mesh(tp=world)
    inp = _load(tmp, "tp_in.pt")
    out = {}
    hp = inp["head_parallel"]
    out["head_parallel"] = head_parallel_rectified_attention(
        mesh, hp["q"], hp["k"], hp["v"], SparseConfig(**hp["cfg"]), None,
        visual_len=hp["q"].shape[2])
    try:
        head_parallel_rectified_attention(
            mesh, hp["q"][:, :3], hp["k"][:, :3], hp["v"][:, :3],
            SparseConfig(**hp["cfg"]), None, visual_len=hp["q"].shape[2])
        out["head_count_error"] = None
    except ValueError as e:
        out["head_count_error"] = str(e)
    for name, c in inp["pipelines"].items():
        model = _model(c["kind"], c["state_dict"])
        if c["kind"].startswith("hunyuan"):
            pipe = HunyuanVideoPipeline(model=model, device="cpu", mesh=mesh,
                                        **c["kw"])
            lat = pipe(c["text"], c["mask"], init_latents=c["init"],
                       first_frame=c.get("first_frame"))
        else:
            pipe = WanPipeline(model=model, device="cpu", mesh=mesh,
                               **c["kw"])
            lat = pipe.denoise(c["init"], c["text_c"], c["text_u"])
        heads = [m.heads for m in model.modules() if hasattr(m, "heads")]
        out[name] = {"latents": lat, "decisions": pipe.teacache.decisions,
                     "heads": heads}
    out["cli"] = main(inp["cli_argv"])
    torch.save(out, os.path.join(tmp, f"tp_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def cog_tp_worker(rank: int, world: int, tmp: str):
    """The tiny CogVideoX pipeline of cog_tp_in.pt at tp = ``world``;
    writes cog_tp_out_<rank>.pt (latents, TeaCache decisions, the sparse
    calls and each block's head count)."""
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.models import (CogVideoXConfig,
                                                    CogVideoXDiT)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.pipelines import CogVideoXPipeline
    c = _load(tmp, "cog_tp_in.pt")
    model = CogVideoXDiT(CogVideoXConfig.tiny())
    model.load_state_dict(c["state_dict"])
    pipe = CogVideoXPipeline(model=model, device="cpu",
                             mesh=make_mesh(tp=world), **c["kw"])
    lat = pipe.denoise(c["init"], c["text_c"], c["text_u"])
    torch.save({"latents": lat, "decisions": pipe.teacache.decisions,
                "sparse_calls": pipe.sparse_calls,
                "heads": [b.heads for b in model.blocks]},
               os.path.join(tmp, f"cog_tp_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def flux_tp_worker(rank: int, world: int, tmp: str):
    """The tiny Flux upscale of flux_tp_in.pt (trunk and ControlNet) at
    tp = ``world``; writes flux_tp_out_<rank>.pt (the up stage's tokens,
    both stages' TeaCache decisions and the head counts of the trunk's
    and the ControlNet's blocks)."""
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.models import (
        FluxConfig, FluxControlNet, FluxControlNetConfig, FluxDiT)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.pipelines import (FluxPipeline,
                                                       FluxUpscalePipeline)
    c = _load(tmp, "flux_tp_in.pt")
    model = FluxDiT(FluxConfig.tiny())
    model.load_state_dict(c["state_dict"])
    cn = FluxControlNet(FluxControlNetConfig.tiny())
    cn.load_state_dict(c["cn_state_dict"])
    mesh = make_mesh(tp=world)
    pipe = FluxUpscalePipeline(
        base=FluxPipeline(model=model, device="cpu", mesh=mesh,
                          **c["base_kw"]),
        up=FluxPipeline(model=model, device="cpu", mesh=mesh, **c["up_kw"]),
        controlnet=cn)
    out = pipe(c["text"], c["mask"], c["pooled"], base_init=c["base_init"],
               up_noise=c["up_noise"])
    torch.save({"tokens": out,
                "decisions": [pipe.base.teacache.decisions,
                              pipe.up.teacache.decisions],
                "heads": [m.attn.heads for m in model.dual_blocks]
                + [m.heads for m in model.single_blocks]
                + [m.attn.heads for m in cn.dual_blocks]},
               os.path.join(tmp, f"flux_tp_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dp_tp_worker(rank: int, world: int, tmp: str):
    """At dp 2 x tp 2: each case of dp_in.pt through
    head_parallel_rectified_attention (global in / out; batch_axis "dp"
    and None), and a batch of 1 that dp does not divide; writes
    dp_out_<rank>.pt."""
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.attention import (
        head_parallel_rectified_attention)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.sparse import SparseConfig
    mesh = make_mesh(dp=2, tp=world // 2)
    out = {"mesh": mesh.shape}
    for name, c in _load(tmp, "dp_in.pt").items():
        cfg = SparseConfig(**c["cfg"])
        vl = c["q"].shape[2] - cfg.text_len

        def site(**kw):
            return head_parallel_rectified_attention(
                mesh, c["q"], c["k"], c["v"], cfg, None, visual_len=vl,
                text_len_rt=c.get("text_len_rt"), **kw)
        out[name] = site()
        out[f"{name}_no_batch_axis"] = site(batch_axis=None)
    try:
        head_parallel_rectified_attention(
            mesh, c["q"][:1], c["k"][:1], c["v"][:1], cfg, None,
            visual_len=vl)
        out["batch_error"] = None
    except ValueError as e:
        out["batch_error"] = str(e)
    torch.save(out, os.path.join(tmp, f"dp_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def eval_worker(rank: int, world: int, tmp: str):
    """eval_in.pt's arguments through the launcher (``--distributed``: a
    dp x tp mesh over the group) or through run_eval.main alone (its --tp
    then builds a 1 x tp mesh over the group); writes eval_out_<rank>.pt
    (what the entry point returned, and the frames this rank saved, as
    float arrays by their path under the output directory)."""
    import numpy as np
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.eval import generation, run_eval
    from rectified_spaattn_tpu_torch.parallel.multihost import launch_eval
    c = _load(tmp, "eval_in.pt")
    frames = {}
    for name in ("save_video", "save_image"):
        def saved(arr, path, *a, save=getattr(generation, name), **k):
            frames[os.path.relpath(path, c["out_dir"])] = np.array(arr)
            return save(arr, path, *a, **k)
        setattr(generation, name, saved)
    if c["launcher"]:
        got = launch_eval(["--distributed", *c["argv"]])
    else:
        got = run_eval.main(c["argv"])
    torch.save({"got": got, "frames": frames},
               os.path.join(tmp, f"eval_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def scan_tp_worker(rank: int, world: int, tmp: str):
    """At tp = ``world``: the tiny HunyuanVideo (int8 QLinears) and Wan
    pipelines of scan_tp_in.pt, unrolled and stacked (scan_blocks,
    dispatch_segments=2), each on a model sharded for this rank; writes
    scan_tp_out_<rank>.pt with both latents and the stacked leaves that
    are tp parts."""
    _init(rank, world, tmp)
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, WanConfig, WanDiT, quant)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.pipelines import (HunyuanVideoPipeline,
                                                       WanPipeline)
    mesh = make_mesh(tp=world)
    inp = _load(tmp, "scan_tp_in.pt")
    out = {}

    def hunyuan():
        cfg = dataclasses.replace(HunyuanVideoConfig.tiny(),
                                  num_dual_blocks=2, num_single_blocks=3)
        m = HunyuanVideoDiT(cfg)
        m.load_state_dict(inp["hunyuan"])
        return quant.quantize_model(m, bits=8, min_size=1)

    def wan():
        m = WanDiT(dataclasses.replace(WanConfig.tiny(), num_blocks=5))
        m.load_state_dict(inp["wan"])
        return m

    hkw = dict(height=64, width=128, frames=8, num_steps=2, mode="sparse",
               sa_drop_rate=0.5, p_remain_rates=0.5, text_len=128,
               group_rows=2, enable_teacache=True, rel_l1_thresh=0.8,
               device="cpu", mesh=mesh)
    wkw = dict(height=192, width=240, frames=5, num_steps=2, mode="sparse",
               sa_drop_rate=0.5, p_remain_rates=0.5, warm_layers=1,
               warm_calls=0, device="cpu", mesh=mesh)
    g = torch.Generator()
    g.manual_seed(3)
    text_c = torch.randn((1, 6, 32), generator=g)
    for name, build, make, run in (
            ("hunyuan", hunyuan, HunyuanVideoPipeline,
             lambda p: p(inp["text"], inp["mask"], init_latents=inp["init"])),
            ("wan", wan, WanPipeline,
             lambda p: p.denoise(torch.zeros((1, 4, *p.grid)) + 0.5, text_c,
                                 torch.zeros_like(text_c)))):
        kw = hkw if name == "hunyuan" else wkw
        res = {"unrolled": run(make(model=build(), **kw))}
        pipe = make(model=build(), scan_blocks=True, dispatch_segments=2,
                    **kw)
        res["scan"] = run(pipe)
        stacks = (pipe.stacks if name == "hunyuan" else (pipe.stack,))
        leaves = [n for st in stacks for n in st.params]
        # the row-parallel parts, and Wan's norms over the full width
        res["sharded_leaves"] = [n for n in leaves if ".parts." in n]
        res["int8_leaves"] = [n for n in leaves if n.endswith("weight_q")]
        res["sharded_norms"] = [
            n for st in stacks for n, m in st.blocks[0].named_modules()
            if type(m).__name__ == "ShardedRMSNorm"]
        out[name] = res
    torch.save(out, os.path.join(tmp, f"scan_tp_out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
