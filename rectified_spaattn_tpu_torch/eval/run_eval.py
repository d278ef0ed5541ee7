"""Batch evaluation entry point of the port (port of
rectified_spaattn_tpu/eval/run_eval.py) -- the reference's inference.sh +
evaluation.sh in one (reference: eval/video/{inference,evaluation}.sh,
eval/video/experiments/multigpu_*.py).

    python -m rectified_spaattn_tpu_torch.eval.run_eval \\
        --model hunyuan --prompts prompts.json --limit 600 \\
        --out_dir ./eval_out --loops 1 --mode sparse [--score]

The flags are the JAX run_eval's, plus ``--device`` (default cuda; the run
raises without a GPU unless ``--device cpu``).  Every family runs through
its real pipeline, built by the CLI's builders (cli/generate.py) from the
CLI's defaults with run_eval's flags on top.  Prompts shard across workers
with the reference interleaving (prompt_list[i::num_shards]); generation
is per-prompt seeded with ``{prompt}-{loop}`` naming.  --score writes a
merged scores.json in the reference's print_scores.py spirit: the
always-live dense-vs-sparse diff metrics plus every gated adapter (VBench,
VisionReward, CLIPScore, FID) with its availability.  Several processes
run through parallel/multihost.py, which hands ``main`` a (dp, tp) mesh:
each dp slice runs its shard with a pipeline sharded over its tp group,
and only tp rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .generation import to_host

FAMILIES = ("hunyuan", "hunyuan-i2v", "wan21-t2v", "wan21-i2v",
            "wan22-t2v", "wan22-i2v", "wan22-ti2v", "cogvideox-t2v",
            "cogvideox-i2v", "flux-upscale")


FAMILY_KEYS = {"hunyuan": "hunyuan", "wan": "wan", "cog": "cogvideox",
               "flux": "flux"}


def _prompt_encoder(args):
    """(encode(prompt, max_len, dim) -> (emb, mask), pooled_fn, is_real):
    the snapshot's text encoders when --ckpt_dir carries them (eval scores
    are never computed over pseudo-embeddings where real encoders exist),
    the CLI's seeded pseudo-embedding (``_random_text``) otherwise, on
    ``args.device``.  pooled_fn (prompt -> CLIP pooled embedding) is
    non-None when the checkpoint ships a second (pooled) encoder; callers
    re-pool PER PROMPT (hunyuan / flux condition on it; the build-time
    pooled is prompts[0]'s)."""
    from ..cli import generate as G
    device = getattr(args, "device", "cuda")
    encoders = []
    if getattr(args, "ckpt_dir", None):
        from ..models.pretrained import load_text_encoders
        fam = next(v for k, v in FAMILY_KEYS.items()
                   if args.model.startswith(k))
        encoders = load_text_encoders(fam, args.ckpt_dir, device=device)

    if encoders:
        def encode(prompt, max_len, dim):
            emb, mask = encoders[0](prompt)
            return torch.as_tensor(emb), torch.as_tensor(mask)

        pooled_fn = None
        if len(encoders) > 1 and hasattr(encoders[1], "pooled"):
            pooled_fn = lambda pr: torch.as_tensor(encoders[1].pooled(pr))
        return encode, pooled_fn, True

    return (lambda prompt, max_len, dim: G._random_text(
        prompt, max_len, dim, device=device)), None, False


def make_runner(args):
    """Build the family's pipeline ONCE and return
    (run(prompt, seed) -> frames, is_video): text re-encodes per prompt
    (through the checkpoint's real encoders when present), the model and
    the sparse site are reused across the batch.  ``run.last_raw()`` is
    the full output of the last call, on the host."""
    from ..cli import generate as G

    m = args.model
    encode, pooled_fn, args.real_text_encoders = _prompt_encoder(args)

    raw_holder = []

    def to_frames(out, video=True):
        arr = to_host(out)
        # keep the FULL tensor for scoring: the channel-mean below is a
        # preview, and averaging channels hides per-channel sparse-vs-
        # dense deviations
        raw_holder.clear()
        raw_holder.append(arr)
        if video:
            if arr.ndim == 5 and arr.shape[1] == 3:      # decoded pixels
                return arr[0].transpose(1, 2, 3, 0)
            lat = arr[0].mean(axis=0)[..., None]         # [F,H,W,1]
        else:
            if arr.ndim == 4 and arr.shape[1] == 3:
                return arr[0].transpose(1, 2, 0)
            lat = arr[0].mean(axis=0)[..., None]         # [H,W,1]
        lo, hi = lat.min(), lat.max()
        return (lat - lo) / (hi - lo + 1e-8)

    def _with_raw(run, is_video):
        run.last_raw = lambda: raw_holder[0] if raw_holder else None
        return run, is_video

    if m.startswith("hunyuan"):
        pipe, _, extra = G.build_hunyuan(args)
        dim = pipe.model.cfg.text_dim

        def run(prompt, seed):
            text, mask = encode(prompt, 256, dim)
            kw = dict(extra)
            if pooled_fn is not None:     # checkpoint CLIP pooled branch
                kw["pooled"] = pooled_fn(prompt)
            return to_frames(pipe(text, mask, seed=seed, **kw))
        return _with_raw(run, True)

    if m.startswith("wan"):
        pipe, (_, neg), extra = G.build_wan(args)
        ref = pipe.high if hasattr(pipe, "high") else pipe
        dim = ref.model.cfg.text_dim

        def run(prompt, seed):
            text = encode(prompt, 512, dim)[0]
            if hasattr(pipe, "high"):                     # A14B dual
                cond = extra.get("condition")
                noise_ch = ref.model.cfg.in_channels - (
                    cond.shape[1] if cond is not None else 0)
                gen = torch.Generator(device=ref.device)
                gen.manual_seed(seed)
                lat = torch.randn((1, noise_ch, *ref.grid), generator=gen,
                                  dtype=torch.float32, device=ref.device)
                out = pipe.denoise(lat, text, neg, condition=cond)
            else:
                out = pipe(text, neg, seed=seed, **extra)
            return to_frames(out)
        return _with_raw(run, True)

    if m.startswith("cogvideox"):
        pipe, (_, neg), extra = G.build_cogvideox(args)
        dim = pipe.model.cfg.text_dim

        def run(prompt, seed):
            text = encode(prompt, 256, dim)[0]
            return to_frames(pipe(text, neg, seed=seed, **extra))
        return _with_raw(run, True)

    if m == "flux-upscale":
        pipe, (_, _, pooled), _ = G.build_flux(args)
        dim = pipe.up.model.cfg.text_dim

        def run(prompt, seed):
            text, tmask = encode(prompt, 512, dim)
            p = pooled_fn(prompt) if pooled_fn is not None else pooled
            return to_frames(pipe(text, tmask, p, seed=seed), video=False)
        return _with_raw(run, False)

    raise SystemExit(f"unknown model {m}; choose from {FAMILIES}")


def _score_view(arr):
    """Full-tensor scoring view: [B,C,F,H,W] -> [F,H,W,C] (or [B,C,H,W] ->
    [H,W,C]) so SSIM windows the spatial dims while EVERY channel is
    compared (reference full-RGB analogue: eval_image_diff.py:22-69).
    Already-decoded pixel tensors pass through the same transpose."""
    a = np.asarray(arr)[0]
    return np.moveaxis(a, 0, -1)


def _norm_pair(a, b):
    """Joint [0,1] normalization: raw latents are unbounded, and the diff
    metrics' _to01 would clip them; one SHARED affine map keeps every
    sparse-vs-dense deviation intact (per-tensor min/max would hide a
    global scale error)."""
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    s = 1.0 / (hi - lo + 1e-12)
    return (a - lo) * s, (b - lo) * s


def score_outputs(args, prompts, sparse_dir, run_sparse=None,
                  write: bool = True, sparse_raw=None):
    """Merged scoring: live diff metrics (a dense rerun of the same seeds)
    + every gated adapter, one JSON (reference: print_scores.py).
    ``run_sparse`` is the main run's runner, reused for the sparse side
    (it gives the same outputs as a second build, without a second model
    tree on the card); None builds one.  ``sparse_raw`` maps a prompt to
    the main run's full output of it at seed 0 (``run.last_raw()``): those
    prompts are not run sparse again.  ``write`` False (tensor-parallel
    ranks past 0) runs the dense reference without saving it.  The dense
    reference covers the whole prompt grid, whatever this worker's
    shard."""
    from . import quality
    from .diff_metrics import cosine_similarity, evaluate_pair, relative_l1
    from .generation import generate_batch

    results = {}

    # 1. dense-vs-sparse diff metrics -- always live (same seeds, both
    # execution modes, compared pre-encode so codecs don't pollute them),
    # computed on the FULL latent/pixel tensor: channel-averaged previews
    # would hide per-channel deviations
    dense_args = argparse.Namespace(**vars(args))
    dense_args.mode = "flash"
    run_dense, is_video = make_runner(dense_args)
    if run_sparse is None:
        run_sparse, _ = make_runner(args)
    sparse_raw = sparse_raw or {}
    dense_dir = os.path.join(args.out_dir, "dense_ref")

    def _full(run, prompt):
        # the metrics run in float64 on the run's device
        raw = sparse_raw.get(prompt) if run is run_sparse else None
        if raw is None:
            frames = run(prompt, 0)
            raw = getattr(run, "last_raw", lambda: None)()
        return torch.as_tensor(
            _score_view(raw) if raw is not None else frames,
            device=args.device)

    diffs = []
    for p in prompts[:2]:
        sparse_full = _full(run_sparse, p)
        dense_full = _full(run_dense, p)
        d = evaluate_pair(*_norm_pair(sparse_full, dense_full))
        # scale-free metrics are better computed on the raw values (the
        # joint shift above changes the rel-L1 denominator)
        d["relative_l1"] = relative_l1(sparse_full, dense_full)
        d["cosine"] = cosine_similarity(sparse_full, dense_full)
        diffs.append({k: v for k, v in d.items() if v is not None})
    if not is_video:
        # FID needs MATCHED sample sets: the dense reference covers the
        # SAME prompt/loop grid as the sparse outputs, not a 2-prompt
        # subset (a 2-image folder gives a rank-deficient covariance over
        # a different prompt set)
        generate_batch(lambda *i, seed=0: run_dense(*i, seed), prompts,
                       dense_dir, loops=args.loops, is_video=False,
                       shard_index=0, num_shards=1,
                       encode_fn=lambda pr: (pr,), write=write)
    if diffs:
        results["diff_vs_dense"] = {
            k: float(np.mean([d[k] for d in diffs])) for k in diffs[0]}

    # 2. gated adapters
    videos = sorted(
        os.path.join(sparse_dir, f) for f in os.listdir(sparse_dir)
        if f.endswith((".mp4", ".png"))) if os.path.isdir(sparse_dir) else []
    hash_text = not getattr(args, "real_text_encoders", False)
    refused = {"available": False,
               "status": "refused: prompts were embedded with hash "
                         "pseudo-embeddings (no text encoder in "
                         "--ckpt_dir); text-conditioned scores would be "
                         "meaningless"}
    results["vbench"] = quality.run_vbench(sparse_dir, device=args.device)
    if is_video:
        results["vision_reward"] = (
            refused if hash_text else quality.run_visionreward(
                videos, prompts, device=args.device))
    else:
        # VisionReward is a video metric; report inapplicability instead
        # of a caught frame-permute exception on [H,W,C] images
        results["vision_reward"] = {
            "available": False,
            "status": "not applicable to image outputs"}
        results["clip_score"] = (refused if hash_text
                                 else quality.clip_score(videos, prompts))
        fid = quality.fid_score(sparse_dir, dense_dir)
        n_sparse, n_dense = len(videos), len(
            [f for f in os.listdir(dense_dir)
             if f.endswith(".png")] if os.path.isdir(dense_dir) else [])
        fid["samples"] = {"sparse": n_sparse, "dense": n_dense}
        if min(n_sparse, n_dense) < 32 and fid.get("available"):
            fid["warning"] = (
                f"small-n FID ({n_sparse} vs {n_dense} samples): the "
                "covariance estimate is unreliable below ~32 samples")
        results["fid"] = fid
    results["live_metrics"] = (
        list(results.get("diff_vs_dense", {})) +
        [k for k in ("vbench", "vision_reward", "clip_score", "fid")
         if results.get(k, {}).get("available")])
    return results


def parse_args(argv=None):
    """run_eval's flags on top of the CLI's defaults (cli/generate.py's
    parse_args), so that every attribute the builders read exists; then
    the operating point run_eval fixes (the model's sparsity defaults,
    TeaCache off, the first prompt as the build-time prompt)."""
    from ..cli import generate as G
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="hunyuan", choices=FAMILIES)
    ap.add_argument("--prompts", required=True,
                    help=".json or .txt prompt list")
    ap.add_argument("--limit", type=int, default=None,
                    help="seeded subsample size (reference: 600 @ seed 42)")
    ap.add_argument("--out_dir", default="./eval_out")
    ap.add_argument("--loops", type=int, default=1)
    ap.add_argument("--mode", default="sparse")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frame", type=int, default=16)
    ap.add_argument("--num_steps", type=int, default=10)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--shard_index", type=int, default=None)
    ap.add_argument("--num_shards", type=int, default=None)
    ap.add_argument("--score", action="store_true",
                    help="diff metrics + gated quality adapters afterwards")
    ap.add_argument("--image", default=None)
    ap.add_argument("--ckpt_dir", default=None,
                    help="diffusers snapshot: real weights AND real text "
                         "encoders for prompt embedding")
    ap.add_argument("--controlnet_dir", default=None)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh size (as in the CLI)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    own = ap.parse_args(argv)
    args = G.parse_args(["--model", own.model])
    for k, v in vars(own).items():
        setattr(args, k, v)
    args.sa_drop_rate, args.teacache_thresh = G.DEFAULTS.get(
        args.model, (0.8, 0.15))
    args.p_remain_rates = 0.3
    args.enable_teacache = False
    args.use_ret_steps = False
    args.profile = None
    G._check_ported(args)
    return args


def main(argv=None, mesh=None):
    """Generate this worker's shard and, with --score, score it.  ``mesh``
    (parallel/multihost.py::launch_eval) is the world's (dp, tp) mesh: the
    pipelines shard over its tp group when tp > 1, only tp rank 0 writes,
    and the scoring runs on dp slice 0 once every slice has written.
    Without --shard_index / --num_shards the shard is the dp slice's, of
    the caller's mesh or of --tp's 1 x tp mesh (every tp rank of a slice
    runs the same prompts); with no mesh at all, shard_prompts' defaults
    (the global rank and world size, as JAX's process index / count)."""
    import torch.distributed as dist
    from ..cli import generate as G
    from .generation import generate_batch, load_prompts

    args = parse_args(argv)
    prompts = load_prompts(args.prompts, limit=args.limit, seed=42)
    args.prompt = prompts[0] if prompts else ""
    # a tp group of one shards nothing: the pipelines then run alone
    args.mesh = mesh if mesh is not None and mesh.shape["tp"] > 1 else None
    args.mesh, owned = G._tp_mesh(args)
    try:
        shard_mesh = mesh if mesh is not None else args.mesh
        if shard_mesh is not None:
            if args.shard_index is None:
                args.shard_index = shard_mesh.group("dp").rank
            if args.num_shards is None:
                args.num_shards = shard_mesh.shape["dp"]
        write = args.mesh is None or args.mesh.group("tp").rank == 0
        run, is_video = make_runner(args)
        kept = {}       # the scored prompts' full outputs, for score_outputs

        def generate(prompt, seed=0):
            frames = run(prompt, seed)
            if args.score and seed == 0 and prompt in prompts[:2]:
                kept[prompt] = run.last_raw()
            return frames
        written = generate_batch(
            generate, prompts, args.out_dir,
            loops=args.loops, is_video=is_video,
            shard_index=args.shard_index, num_shards=args.num_shards,
            encode_fn=lambda p: (p,), write=write)
        if write:
            print(json.dumps({"generated": len(written),
                              "out_dir": args.out_dir,
                              "files": [os.path.basename(p)
                                        for p in written]}), flush=True)
        res = None
        if args.score:
            if mesh is not None and mesh.shape["dp"] > 1:
                # the adapters read every slice's files: wait for them,
                # then score once, on dp slice 0
                dist.barrier()
                if mesh.group("dp").rank != 0:
                    return written, None
            from .quality import write_scores
            res = score_outputs(args, prompts, args.out_dir, run_sparse=run,
                                write=write, sparse_raw=kept)
            if write:
                path = write_scores(res, os.path.join(args.out_dir,
                                                      "scores.json"))
                print(json.dumps({"scores": path,
                                  "live_metrics": res.get("live_metrics")}),
                      flush=True)
        return written, res
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
