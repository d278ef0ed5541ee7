"""Quality-benchmark adapters (port of rectified_spaattn_tpu/eval/quality.py):
VBench, VisionReward, CLIPScore/ImageReward, FID (reference:
eval/video/vbench/run_vbench.py, print_scores.py,
eval/image/evaluation/test_score.py, fid_score.py).

The reference vendors entire third-party metric repos; here each suite is
a thin adapter that activates when its (heavy, GPU-era) dependency stack
is installed, and reports ``available: False`` otherwise — the dense-vs-
sparse diff metrics (diff_metrics.py) are the first-line quality gate.
VBench and VisionReward run on ``device`` (default "cuda"); the image
scorers keep the JAX package's CPU models, and the Frechet distance is
host math on one covariance (numpy).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

VBENCH_DIMENSIONS = (
    # the 6 dimensions the reference scores (run_vbench.py:27-34)
    "subject_consistency", "imaging_quality", "background_consistency",
    "motion_smoothness", "aesthetic_quality", "dynamic_degree",
)


def run_vbench(video_dir: str, dimensions: Sequence[str] = VBENCH_DIMENSIONS,
               output_path: str | None = None,
               full_info_path: str | None = None, device="cuda") -> dict:
    """Mirror of the reference's vbench invocation
    (eval/video/vbench/run_vbench.py:46-60): one VBench instance PER
    dimension, constructed (device, full_info_path, save_path), evaluated
    with mode="custom_input", local=False, read_frame=False and the
    imaging-quality preprocessing default pinned to "longer"."""
    try:
        from vbench import VBench  # heavy external suite
    except Exception:
        return {"available": False,
                "reason": "vbench not installed", "dimensions": list(dimensions)}
    from ..utils.device import resolve_device
    save_path = output_path or video_dir
    kwargs = {"imaging_quality_preprocessing_mode": "longer"}
    results = {}
    for dim in dimensions:
        bench = VBench(resolve_device(device), full_info_path, save_path)
        bench.evaluate(videos_path=video_dir, name=dim, local=False,
                       read_frame=False, dimension_list=[dim],
                       mode="custom_input", **kwargs)
        results[dim] = "see_eval_results_json"
    return {"available": True, "results": results}


def _visionreward_load(device="cuda"):
    """Load the VisionReward VLM (on ``device``) + its question list and
    weight vector.  RSA_TPU_VISIONREWARD may point at a local checkpoint
    dir; the questions/weights default to the files VisionReward ships
    (reference: inference-video.py:11-20)."""
    from transformers import AutoModelForCausalLM, AutoTokenizer
    name = os.environ.get("RSA_TPU_VISIONREWARD", "THUDM/VisionReward-Video")
    qpath = os.environ.get(
        "RSA_TPU_VISIONREWARD_QA",
        os.path.join(name, "VisionReward_video_qa_select.txt"))
    wpath = os.environ.get("RSA_TPU_VISIONREWARD_WEIGHT",
                           os.path.join(name, "weight.json"))
    with open(qpath) as f:
        questions = [ln.strip() for ln in f if ln.strip()]
    with open(wpath) as f:
        weight = np.asarray(json.load(f), dtype=np.float64)
    tok = AutoTokenizer.from_pretrained(name, trust_remote_code=True)
    model = AutoModelForCausalLM.from_pretrained(
        name, torch_dtype=torch.float32,
        trust_remote_code=True).to(device).eval()
    return model, tok, questions, weight


def _sample_video_frames(path: str, num_frames: int = 24):
    """~1 fps frame sampling capped at num_frames
    (reference: inference-video.py::load_video 'chat' strategy), via
    imageio instead of decord."""
    import imageio.v3 as iio
    frames = iio.imread(path, plugin="pyav") if path.endswith(".mp4") else \
        iio.imread(path)
    idx = np.linspace(0, len(frames) - 1, min(num_frames, len(frames)),
                      dtype=int)
    video = torch.from_numpy(np.asarray(frames)[idx])       # [T,H,W,C]
    return video.permute(3, 0, 1, 2)                        # [C,T,H,W]


def run_visionreward(video_paths: Sequence[str],
                     prompts: Sequence[str] | None = None,
                     device="cuda") -> dict:
    """VisionReward VLM scoring: each video is asked the checkpoint's
    yes/no question set; score = mean(weight * ±1 answers)
    (reference: eval/video/VisionReward/inference-video.py:107-113).
    Runs whenever the THUDM/VisionReward-Video checkpoint (or a local dir
    via RSA_TPU_VISIONREWARD) is resolvable."""
    video_paths = list(video_paths)
    prompts = list(prompts) if prompts is not None else [""] * len(video_paths)
    try:
        model, tok, questions, weight = _visionreward_load(device)
    except Exception as e:
        return {"available": False,
                "reason": f"VisionReward checkpoint unavailable ({e})",
                "videos": len(video_paths)}
    try:
        return _visionreward_score(model, tok, questions, weight,
                                   video_paths, prompts)
    except Exception as e:  # frame decode / generation failure mid-run
        return {"available": False,
                "reason": f"VisionReward scoring failed ({e})",
                "videos": len(video_paths)}


def _visionreward_score(model, tok, questions, weight, video_paths,
                        prompts):
    dev = next(model.parameters()).device
    scores = []
    for path, prompt in zip(video_paths, prompts):
        video = _sample_video_frames(path)
        answers = []
        for q in questions:
            query = q.replace("[[prompt]]", prompt)
            inputs = model.build_conversation_input_ids(
                tokenizer=tok, query=query, images=[video], history=[],
                template_version="chat")
            batch = {
                "input_ids": inputs["input_ids"].unsqueeze(0).to(dev),
                "token_type_ids": inputs["token_type_ids"].unsqueeze(0).to(
                    dev),
                "attention_mask": inputs["attention_mask"].unsqueeze(0).to(
                    dev),
                "images": [[inputs["images"][0].to(dev, torch.float32)]],
            }
            with torch.no_grad():
                # exact gen_kwargs of the vendored scorer
                # (inference-video.py:93-100)
                out = model.generate(**batch, max_new_tokens=2048,
                                     pad_token_id=128002, top_k=1,
                                     do_sample=False, top_p=0.1,
                                     temperature=0.1)
                out = out[:, batch["input_ids"].shape[1]]
            answers.append(1 if tok.decode(out[0]) == "yes" else -1)
        scores.append(float(np.mean(np.asarray(answers) * weight)))
    return {"available": True,
            "vision_reward": float(np.mean(scores)),
            "per_video": scores, "n": len(scores)}


def clip_score(image_paths: Sequence[str], prompts: Sequence[str]) -> dict:
    try:
        from transformers import CLIPModel, CLIPProcessor
        from PIL import Image
    except Exception:
        return {"available": False, "reason": "clip deps not installed"}
    name = os.environ.get("RSA_TPU_CLIP", "openai/clip-vit-base-patch32")
    try:
        model = CLIPModel.from_pretrained(name)
        proc = CLIPProcessor.from_pretrained(name)
    except Exception:
        return {"available": False, "reason": "clip weights unavailable"}
    scores = []
    for path, prompt in zip(image_paths, prompts):
        inputs = proc(text=[prompt], images=Image.open(path),
                      return_tensors="pt", padding=True, truncation=True)
        with torch.no_grad():
            out = model(**inputs)
        img = out.image_embeds / out.image_embeds.norm(dim=-1, keepdim=True)
        txt = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
        scores.append(float((img * txt).sum()))
    return {"available": True, "clip_score": float(np.mean(scores)),
            "n": len(scores)}


def image_reward(image_paths: Sequence[str], prompts: Sequence[str]) -> dict:
    """ImageReward scoring (reference vendors THUDM/ImageReward,
    eval/image/evaluation/metrics/ImageReward)."""
    try:
        import ImageReward as ir
    except Exception:
        return {"available": False, "reason": "ImageReward not installed"}
    try:
        model = ir.load("ImageReward-v1.0")
    except Exception:
        return {"available": False, "reason": "ImageReward weights unavailable"}
    scores = [float(model.score(p, img))
              for img, p in zip(image_paths, prompts)]
    return {"available": True, "image_reward": float(np.mean(scores)),
            "n": len(scores)}


def pick_score(image_paths: Sequence[str], prompts: Sequence[str]) -> dict:
    """PickScore preference scoring (reference vendors PickScore,
    eval/image/evaluation/metrics/PickScore)."""
    try:
        from transformers import AutoModel, AutoProcessor
        from PIL import Image
    except Exception:
        return {"available": False, "reason": "pickscore deps not installed"}
    name = os.environ.get("RSA_TPU_PICKSCORE",
                          "yuvalkirstain/PickScore_v1")
    try:
        proc = AutoProcessor.from_pretrained(
            "laion/CLIP-ViT-H-14-laion2B-s32B-b79K")
        model = AutoModel.from_pretrained(name)
    except Exception:
        return {"available": False, "reason": "pickscore weights unavailable"}
    scores = []
    for path, prompt in zip(image_paths, prompts):
        inputs = proc(text=[prompt], images=Image.open(path),
                      return_tensors="pt", padding=True, truncation=True)
        with torch.no_grad():
            out = model(**inputs)
        img = out.image_embeds / out.image_embeds.norm(dim=-1, keepdim=True)
        txt = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
        scores.append(float(model.logit_scale.exp() * (img * txt).sum()))
    return {"available": True, "pick_score": float(np.mean(scores)),
            "n": len(scores)}


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians
    ||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) — the exact computation of
    the reference's calculate_frechet_distance
    (eval/image/evaluation/fid_score.py), with the same eps-jitter retry
    and imaginary-component tolerance, via an eigendecomposition-based
    matrix square root (no scipy dependency)."""
    diff = mu1 - mu2

    def sqrtm_product(s1, s2):
        # sqrt(S1 S2) is similar to the PSD sqrt(sqrt(S1) S2 sqrt(S1));
        # only its TRACE is needed, which equals the trace of the latter
        w1, v1 = np.linalg.eigh(s1)
        w1 = np.clip(w1, 0, None)
        root1 = (v1 * np.sqrt(w1)) @ v1.T
        inner = root1 @ s2 @ root1
        w = np.linalg.eigvalsh(inner)
        return np.sqrt(np.clip(w, 0, None)).sum()

    tr_covmean = sqrtm_product(sigma1, sigma2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = sqrtm_product(sigma1 + offset, sigma2 + offset)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)


def activation_statistics(features: np.ndarray):
    """(mu, sigma) of an [N, D] activation matrix
    (reference: fid_score.py::calculate_activation_statistics)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _inception_features(image_paths: Sequence[str], batch_size: int = 8):
    """Pool3 activations of InceptionV3 (the FID feature layer).  Gated on
    torchvision + downloadable/locally-cached weights (RSA_TPU_INCEPTION
    may point at a state-dict file for air-gapped machines)."""
    from torchvision.models import inception_v3
    from torchvision import transforms
    from PIL import Image

    local = os.environ.get("RSA_TPU_INCEPTION")
    if local and os.path.exists(local):
        model = inception_v3(weights=None, init_weights=False, aux_logits=True)
        model.load_state_dict(torch.load(local, map_location="cpu"))
    else:
        model = inception_v3(weights="DEFAULT")
    model.fc = torch.nn.Identity()
    model.eval()
    prep = transforms.Compose([
        transforms.Resize((299, 299)),
        transforms.ToTensor(),
        transforms.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    ])
    feats = []
    with torch.no_grad():
        for i in range(0, len(image_paths), batch_size):
            batch = torch.stack([
                prep(Image.open(p).convert("RGB"))
                for p in image_paths[i:i + batch_size]])
            feats.append(model(batch).numpy())
    return np.concatenate(feats, axis=0)


def fid_score(dir_a: str, dir_b: str) -> dict:
    """Inception FID between two image folders (reference:
    eval/image/evaluation/fid_score.py — same pipeline: pool3 activations
    → per-folder Gaussian stats → Frechet distance)."""
    try:
        from torchvision.models import inception_v3  # noqa: F401
    except Exception:
        return {"available": False, "reason": "torchvision not installed"}
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
    paths_a = sorted(os.path.join(dir_a, f) for f in os.listdir(dir_a)
                     if f.lower().endswith(exts))
    paths_b = sorted(os.path.join(dir_b, f) for f in os.listdir(dir_b)
                     if f.lower().endswith(exts))
    if len(paths_a) < 2 or len(paths_b) < 2:
        return {"available": False,
                "reason": f"need >=2 images per folder "
                          f"({len(paths_a)}/{len(paths_b)})"}
    try:
        fa = _inception_features(paths_a)
        fb = _inception_features(paths_b)
    except Exception as e:  # weights not cached and no network
        return {"available": False,
                "reason": f"inception weights unavailable ({e})"}
    mu_a, s_a = activation_statistics(fa)
    mu_b, s_b = activation_statistics(fb)
    return {"available": True,
            "fid": frechet_distance(mu_a, s_a, mu_b, s_b),
            "n_a": len(paths_a), "n_b": len(paths_b)}


def write_scores(results: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path
