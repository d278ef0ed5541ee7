"""The port's pixel end against the JAX package on the CPU: the
safetensors codec (against the ``safetensors`` package), the diffusers ->
state_dict converters (bit for bit against JAX's ``convert_*`` carried
through models/convert.py), the VAE (fp32 rtol 2e-4 / atol 2e-5,
tests/test_kernels.py:44), the snapshot loaders and their cache, the CLI's
``--ckpt_dir`` path (pixels within the pipelines' fp32 rtol 1e-3 / atol
1e-4, tests/test_models.py:65), video / image output and the text
encoders.  Snapshots are tiny and fp32 (a bf16 one where the port alone
is held)."""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from rectified_spaattn_tpu.cli import generate as jgen
from rectified_spaattn_tpu.models import encoders as jenc
from rectified_spaattn_tpu.models import pretrained as jpre
from rectified_spaattn_tpu.models import vae as jvae
from rectified_spaattn_tpu.models import weights as jw
from rectified_spaattn_tpu.models.hunyuan import HunyuanVideoConfig as JH
from rectified_spaattn_tpu.models.wan import WanConfig as JW
from rectified_spaattn_tpu.utils import video as jvideo
from rectified_spaattn_tpu_torch.cli import generate as gen
from rectified_spaattn_tpu_torch.models import checkpoint as ck
from rectified_spaattn_tpu_torch.models import encoders as enc
from rectified_spaattn_tpu_torch.models import pretrained as pre
from rectified_spaattn_tpu_torch.models import safetensors_io as sio
from rectified_spaattn_tpu_torch.models import vae as tvae
from rectified_spaattn_tpu_torch.models import weights as w
from rectified_spaattn_tpu_torch.models import (HunyuanVideoConfig,
                                                HunyuanVideoDiT, WanConfig,
                                                WanDiT, flax_to_state_dict,
                                                load_flax_params)
from rectified_spaattn_tpu_torch.utils import video

import test_weight_manifests as manifests
import test_weights as tw

torch.set_num_threads(1)
VAE_TOL = dict(rtol=2e-4, atol=2e-5)
PIPE_TOL = dict(rtol=1e-3, atol=1e-4)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------------ codec ---

def every_dtype(seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, dt in sio.DTYPES.items():
        if dt.is_floating_point:
            out[name.lower()] = torch.randn((3, 5), generator=g).to(dt)
        elif dt == torch.bool:
            out[name.lower()] = torch.randint(0, 2, (9,), generator=g).bool()
        else:
            lo = 0 if dt == torch.uint8 else -100
            out[name.lower()] = torch.randint(lo, 100, (2, 3, 4),
                                              generator=g).to(dt)
    out["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    out["scalar"] = torch.tensor(1.5)
    return out


@pytest.mark.parametrize("use_mmap", [True, False])
def test_reader_matches_safetensors(use_mmap, tmp_path):
    """Three shards (every dtype, an empty tensor, a scalar) written by the
    safetensors package, read back bit for bit, shard by shard and as a
    directory in sorted order (other files ignored)."""
    shards = [every_dtype(s) for s in range(3)]
    for i, sd in enumerate(shards):
        st_save_file({f"s{i}.{k}": v for k, v in sd.items()},
                     str(tmp_path / f"model-{i:05d}.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    want = {}
    for fname in sorted(os.listdir(tmp_path)):
        if fname.endswith(".safetensors"):
            with safe_open(str(tmp_path / fname), framework="pt") as f:
                want.update({k: f.get_tensor(k) for k in f.keys()})
            assert_same_state(sio.load_file(str(tmp_path / fname), use_mmap),
                              st_load_file(str(tmp_path / fname)))
    got = sio.load_safetensors_dir(str(tmp_path), use_mmap=use_mmap)
    assert_same_state(got, want)
    assert list(got) == list(want)
    assert w.load_safetensors_dir is sio.load_safetensors_dir


def test_writer_is_read_by_safetensors(tmp_path):
    sd = every_dtype(5)
    path = sio.save_file(sd, str(tmp_path / "x.safetensors"),
                         metadata={"format": "pt", "n": 3})
    assert_same_state(st_load_file(path), sd)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "n": "3"}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert (8 + n) % 8 == 0
    assert os.listdir(tmp_path) == ["x.safetensors"]      # no temp left


def test_reader_rejects_bad_headers(tmp_path):
    def write(header, payload=b""):
        blob = json.dumps(header).encode()
        p = tmp_path / "bad.safetensors"
        p.write_bytes(len(blob).to_bytes(8, "little") + blob + payload)
        return str(p)

    with pytest.raises(ValueError, match="dtype"):
        sio.load_file(write({"a": {"dtype": "C64", "shape": [1],
                                   "data_offsets": [0, 8]}}, bytes(8)))
    with pytest.raises(ValueError, match="needs"):
        sio.load_file(write({"a": {"dtype": "F32", "shape": [3],
                                   "data_offsets": [0, 8]}}, bytes(8)))


def test_jax_reader_agrees_on_fp32_and_bf16(tmp_path):
    """JAX's reader (numpy arrays; bf16 as ml_dtypes' bfloat16, which the
    jax import registers with numpy) and the port's agree bit for bit."""
    np_save_file({"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "b": np.ones(4, np.float32)},
                 str(tmp_path / "x.safetensors"))
    st_save_file({"c": torch.randn(3, 4).to(torch.bfloat16)},
                 str(tmp_path / "y.safetensors"))
    got = sio.load_safetensors_dir(str(tmp_path))
    want = jw.load_safetensors_dir(str(tmp_path))
    assert list(got) == list(want) == ["a", "b", "c"]
    for k, v in want.items():
        if v.dtype.name == "bfloat16":
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy(), v.view(np.int16))
        else:
            assert torch.equal(got[k], t(v))


# ------------------------------------------------------------- converters ---

def wan_i2v_sd(cfg, rng):
    """synth_wan_sd plus the I2V keys (image embedder, image cross)."""
    sd = tw.synth_wan_sd(cfg, rng)
    d, ie = cfg.hidden_dim, "condition_embedder.image_embedder"

    def lin(name, o, i):
        sd[name + ".weight"] = rng.standard_normal((o, i)).astype(
            np.float32) * 0.02
        sd[name + ".bias"] = rng.standard_normal(o).astype(np.float32)

    for n, c in ((f"{ie}.norm1", cfg.image_dim), (f"{ie}.norm2", d)):
        sd[n + ".weight"] = rng.standard_normal(c).astype(np.float32)
        sd[n + ".bias"] = rng.standard_normal(c).astype(np.float32)
    lin(f"{ie}.ff.net.0.proj", cfg.image_dim, cfg.image_dim)
    lin(f"{ie}.ff.net.2", d, cfg.image_dim)
    for i in range(cfg.num_blocks):
        b = f"blocks.{i}.attn2"
        lin(f"{b}.add_k_proj", d, d)
        lin(f"{b}.add_v_proj", d, d)
        sd[f"{b}.norm_added_k.weight"] = rng.standard_normal(d).astype(
            np.float32)
    return sd


def converter_case(name):
    """(port converter call, JAX converter call, the port module whose
    state_dict the output fills) on a synthetic state dict."""
    rng = np.random.default_rng(3)
    if name == "hunyuan":
        c = JH.tiny()
        sd = tw.synth_hunyuan_sd(c, rng)
        args = (c.num_dual_blocks, c.num_single_blocks, c.num_refiner_blocks,
                c.pooled_dim, c.text_dim)
        return (sd, lambda s, **k: w.convert_strict("hunyuan", s, *args, **k),
                lambda s: jw.convert_hunyuan(s, *args),
                HunyuanVideoDiT(HunyuanVideoConfig.tiny()))
    if name in ("wan", "wan_i2v"):
        i2v = name == "wan_i2v"
        c = JW.tiny(image_cross=i2v)
        sd = wan_i2v_sd(c, rng) if i2v else tw.synth_wan_sd(c, rng)
        return (sd, lambda s, **k: w.convert_strict("wan", s, c.num_blocks,
                                                    **k),
                lambda s: jw.convert_wan(s, c.num_blocks),
                WanDiT(WanConfig.tiny(image_cross=i2v)))
    video = name.endswith("video")
    c = jvae.VAEConfig.tiny(video=video, mid_attention=True)
    sd = tw.synth_vae_sd(c, rng)
    if name.startswith("vae_dec"):
        return (sd, lambda s, **k: w.convert_vae_decoder(s, 2, 1, video, **k),
                lambda s: jw.convert_vae_decoder(s, 2, 1, video),
                tvae.VAEDecoder(tvae.VAEConfig.tiny(video=video,
                                                    mid_attention=True)))
    return (sd, lambda s, **k: w.convert_vae_encoder(s, 2, 1, video, **k),
            lambda s: jw.convert_vae_encoder(s, 2, 1, video),
            tvae.VAEEncoder(tvae.VAEConfig.tiny(video=video,
                                                mid_attention=True)))


CONVERTER_CASES = ["hunyuan", "wan", "wan_i2v", "vae_dec_video",
                   "vae_dec_image", "vae_enc_video", "vae_enc_image"]


@pytest.mark.parametrize("name", CONVERTER_CASES)
def test_converter_matches_jax(name):
    """The port's converter straight to state_dict names equals JAX's
    converter carried through flax_to_state_dict, bit for bit, and fills
    the port module's state_dict exactly."""
    sd, ours, theirs, module = converter_case(name)
    got = ours({k: t(v) for k, v in sd.items()})
    assert_same_state(got, flax_to_state_dict(theirs(sd)))
    target = module.state_dict()
    assert sorted(got) == sorted(target)
    for k, v in got.items():
        assert v.shape == target[k].shape, k
    module.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["hunyuan", "wan", "vae_dec_video"])
def test_place_runs_on_each_tensor(name):
    sd, ours, _, _ = converter_case(name)
    seen = []

    def place(x):
        seen.append(x.shape)
        return x.to(torch.bfloat16)

    got = ours({k: t(v) for k, v in sd.items()}, place=place)
    assert len(seen) == len(got)
    assert all(v.dtype == torch.bfloat16 for v in got.values())


@pytest.mark.parametrize("family", ["hunyuan", "wan"])
def test_manifest_is_consumed_whole(family):
    """The expanded tests/manifests/<family>_keys.json is exactly the
    synthetic state dict's key set, and convert_strict reads every key."""
    sd, counts, args, _ = manifests.build_case(family)
    assert set(sd) == manifests.expand_manifest(family, counts)
    tracker = w.TrackedStateDict({k: t(v) for k, v in sd.items()})
    w.CONVERTERS[family](tracker, *args)
    assert tracker.unused == set()
    assert tracker.used == set(sd)


@pytest.mark.parametrize("family", ["hunyuan", "wan"])
def test_unknown_and_missing_keys_raise(family):
    sd, _, args, _ = manifests.build_case(family)
    sd = {k: t(v) for k, v in sd.items()}
    extra = dict(sd)
    extra["transformer_blocks.0.attn.to_q.lora_A.weight"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="not consumed"):
        w.convert_strict(family, extra, *args)
    victim = sorted(k for k in sd if k.endswith(".to_q.weight"))[0]
    missing = {k: v for k, v in sd.items() if k != victim}
    with pytest.raises(KeyError):
        w.convert_strict(family, missing, *args)


def test_conv_rule_of_the_bridge():
    """Flax conv kernels [*k, in, out] -> torch [out, in, *k]."""
    k = np.arange(3 * 3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 3, 2, 5)
    got = flax_to_state_dict({"params": {"conv_in": {"conv": {
        "kernel": k, "bias": np.zeros(5, np.float32)}}}})
    np.testing.assert_array_equal(got["conv_in.conv.weight"].numpy(),
                                  k.transpose(4, 3, 0, 1, 2))


# -------------------------------------------------------------------- VAE ---

VAE_CASES = {
    "video_causal_mid": dict(video=True, mid_attention=True),
    "video_noncausal": dict(video=True, causal=False),
    "image_quant_mid": dict(video=False, mid_attention=True,
                            quant_conv=True),
    "video_quant_mean_std": dict(video=True, quant_conv=True,
                                 latents_mean=(0.1, -0.2, 0.3, 0.0),
                                 latents_std=(1.0, 2.0, 0.5, 1.5)),
}


def jitter(tree, seed):
    """Parameters moved off their init (norm scales off 1, biases off 0)."""
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * g.standard_normal(
            np.shape(a)).astype(np.float32), tree)


def vae_pair(kind, kw, x):
    jcls = jvae.VAEDecoder if kind == "dec" else jvae.VAEEncoder
    tcls = tvae.VAEDecoder if kind == "dec" else tvae.VAEEncoder
    jmod = jcls(jvae.VAEConfig.tiny(**kw))
    params = jitter(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tmod = load_flax_params(tcls(tvae.VAEConfig.tiny(**kw)), params)
    return jmod, params, tmod


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_matches_jax(case):
    kw = VAE_CASES[case]
    assert dataclasses.asdict(tvae.VAEConfig.tiny(**kw)) == \
        dataclasses.asdict(jvae.VAEConfig.tiny(**kw))
    g = np.random.default_rng(2)
    video = kw["video"]
    lat = g.standard_normal((1, 4, 3, 6, 6) if video else (1, 4, 6, 6)
                            ).astype(np.float32)
    jdec, dparams, tdec = vae_pair("dec", kw, lat)
    want = np.asarray(jdec.apply(dparams, jnp.asarray(lat)))
    with torch.no_grad():
        got = tdec(t(lat)).numpy()
    assert got.shape == want.shape == ((1, 3, 5, 12, 12) if kw.get(
        "causal", True) and video else (1, 3, 6, 12, 12) if video
        else (1, 3, 12, 12))
    np.testing.assert_allclose(got, want, **VAE_TOL)
    pix = g.standard_normal(want.shape).astype(np.float32)
    jenc_, eparams, tenc_ = vae_pair("enc", kw, pix)
    want_z = np.asarray(jenc_.apply(eparams, jnp.asarray(pix)))
    with torch.no_grad():
        got_z = tenc_(t(pix)).numpy()
    assert got_z.shape == want_z.shape == lat.shape
    np.testing.assert_allclose(got_z, want_z, **VAE_TOL)


def test_latent_normalisation_matches_jax():
    for kw in ({}, dict(latents_mean=(0.1, -0.2, 0.3, 0.0),
                        latents_std=(1.0, 2.0, 0.5, 1.5)),
               dict(shift_factor=0.3, scaling_factor=0.7)):
        jc, c = jvae.VAEConfig.tiny(**kw), tvae.VAEConfig.tiny(**kw)
        z = np.random.default_rng(1).standard_normal((1, 4, 2, 3, 3)).astype(
            np.float32)
        for jf, f in ((jvae.normalize_latents, tvae.normalize_latents),
                      (jvae.denormalize_latents, tvae.denormalize_latents)):
            np.testing.assert_allclose(f(t(z), c).numpy(),
                                       np.asarray(jf(jnp.asarray(z), jc)),
                                       rtol=1e-6, atol=1e-6)


def test_tiled_decode_matches_jax():
    """A 12 x 20 latent through 8-wide tiles with overlap 2 (a partial
    last tile on each axis), mid attention on."""
    kw = dict(video=True, mid_attention=True)
    lat = np.random.default_rng(6).standard_normal((1, 4, 2, 12, 20)).astype(
        np.float32)
    jdec, params, tdec = vae_pair("dec", kw, lat)
    want = np.asarray(jvae.tiled_decode(
        lambda z: jdec.apply(params, z), jnp.asarray(lat), tile=8, overlap=2))
    with torch.no_grad():
        got = tvae.tiled_decode(tdec, t(lat), tile=8, overlap=2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **VAE_TOL)
    with torch.no_grad():        # within one tile: the plain decode
        small = t(lat[..., :8, :8])
        torch.testing.assert_close(tvae.tiled_decode(tdec, small, 8, 2),
                                   tdec(small), rtol=0, atol=0)


@pytest.mark.parametrize("edge", [True, False])
def test_pad_and_sliced_conv(edge, monkeypatch):
    """_pad is numpy's edge / zero pad; the sliced 3-D conv (forced by a
    tiny slice limit) equals one conv over the padded input, strides 1 and
    2, clips shorter than the kernel included."""
    x = torch.randn(2, 3, 4, 5, 6, generator=torch.Generator().manual_seed(0))
    pads = ((2, 0), (1, 1), (0, 2))
    np.testing.assert_array_equal(
        tvae._pad(x, pads, edge).numpy(),
        np.pad(x.numpy(), ((0, 0), (0, 0), *pads),
               mode="edge" if edge else "constant"))
    for st in (1, 2):
        conv = torch.nn.Conv3d(3, 4, 3, stride=(st, 1, 1))
        for frames in (1, 2, 7):
            y = torch.randn(1, 3, frames, 6, 7)
            p = ((2, 0) if edge else (1, 1), (1, 1), (1, 1))
            with torch.no_grad():
                want = conv(tvae._pad(y, p, edge))
                monkeypatch.setattr(tvae, "_CHUNK_ELEMS", 3 * 8 * 9 * 4)
                got = tvae._conv3d(conv, y, p, edge)
                monkeypatch.undo()
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- loaders ---

HUNYUAN_JSON = dict(num_attention_heads=2, attention_head_dim=32,
                    in_channels=4, out_channels=4, num_layers=1,
                    num_single_layers=1, num_refiner_layers=1, patch_size=2,
                    patch_size_t=1, text_embed_dim=32,
                    pooled_projection_dim=16, rope_axes_dim=[8, 12, 12],
                    guidance_embeds=True)
WAN_JSON = dict(num_attention_heads=2, attention_head_dim=32, in_channels=4,
                out_channels=4, num_layers=2, ffn_dim=128,
                patch_size=[1, 2, 2], text_dim=32, freq_dim=32)
VAE_JSON = dict(latent_channels=4, block_out_channels=[8, 16],
                layers_per_block=1, temporal_compression_ratio=2,
                spatial_compression_ratio=2, scaling_factor=0.476986,
                mid_block_add_attention=True)


def write_snapshot(root, family, with_vae=True, encoder=True):
    """A tiny fp32 diffusers snapshot under ``root``."""
    rng = np.random.default_rng(21)
    tdir = os.path.join(root, "transformer")
    os.makedirs(tdir)
    if family == "hunyuan":
        sd, cj = tw.synth_hunyuan_sd(JH.tiny(), rng), HUNYUAN_JSON
    else:
        sd, cj = tw.synth_wan_sd(JW.tiny(), rng), WAN_JSON
    # split over two shards, as published snapshots are
    keys = sorted(sd)
    for i, part in enumerate((keys[::2], keys[1::2])):
        np_save_file({k: sd[k] for k in part}, os.path.join(
            tdir, f"diffusion_pytorch_model-{i + 1:05d}-of-00002"
                  ".safetensors"))
    with open(os.path.join(tdir, "config.json"), "w") as f:
        json.dump(cj, f)
    if with_vae:
        vdir = os.path.join(root, "vae")
        os.makedirs(vdir)
        vsd = tw.synth_vae_sd(jvae.VAEConfig.tiny(mid_attention=True),
                              np.random.default_rng(22))
        if not encoder:
            vsd = {k: v for k, v in vsd.items() if k.startswith("decoder.")}
        np_save_file(vsd, os.path.join(vdir, "diffusion_pytorch_model"
                                             ".safetensors"))
        with open(os.path.join(vdir, "config.json"), "w") as f:
            json.dump(VAE_JSON, f)
    return root


@pytest.mark.parametrize("family", ["hunyuan", "wan"])
def test_transformer_config_from_json(family):
    """Field by field, including a config with every optional key."""
    cj = dict(HUNYUAN_JSON if family == "hunyuan" else WAN_JSON)
    variants = [cj]
    if family == "wan":
        variants.append({**cj, "image_dim": 16, "expand_timesteps": True,
                         "rope_axes_dim": [16, 8, 8]})
    else:
        variants.append({k: v for k, v in cj.items()
                         if k not in ("num_refiner_layers", "rope_axes_dim",
                                      "text_embed_dim")})
    for c in variants:
        ours = pre.CONFIG_PARSERS[family](c)
        theirs = jpre.CONFIG_PARSERS[family](c)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("video", [True, False])
def test_vae_config_from_json(video):
    for c in (VAE_JSON, {**VAE_JSON, "latents_mean": [0.0] * 4,
                         "latents_std": [1.0] * 4, "use_quant_conv": True,
                         "shift_factor": 0.1},
              {"block_out_channels": [8, 16, 16]}):
        assert dataclasses.asdict(pre.vae_config_from_json(c, video)) == \
            dataclasses.asdict(jpre.vae_config_from_json(c, video))


@pytest.mark.parametrize("family", ["hunyuan", "wan"])
def test_load_transformer_matches_jax_and_caches(family, tmp_path):
    """The port's load equals JAX's (cache off) carried across, bit for
    bit; the port's cache directory is its own, and a second load from it
    gives the same tensors."""
    root = write_snapshot(str(tmp_path), family)
    jcfg, params = jpre.load_transformer(family, root, dtype="float32",
                                         cache=False)
    cfg, model = pre.load_transformer(family, root, dtype="float32",
                                      device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    first = model.state_dict()
    assert_same_state(first, flax_to_state_dict(params))
    tdir = os.path.join(root, "transformer")
    assert sorted(os.listdir(tdir))[0] == pre.CACHE_DIR
    assert not os.path.exists(os.path.join(tdir, ".rsa_tpu_params"))
    assert ck.has_params(os.path.join(tdir, pre.CACHE_DIR))
    _, again = pre.load_transformer(family, root, dtype="float32",
                                    device="cpu")
    assert_same_state(again.state_dict(), first)
    _, nocache = pre.load_transformer(family, root, dtype="float32",
                                      cache=False, strict=False,
                                      device="cpu")
    assert_same_state(nocache.state_dict(), first)
    _, bf = pre.load_transformer(family, root, cache=False, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.state_dict().values())


def test_bf16_snapshot_loads_in_its_dtype(tmp_path):
    """A bf16 snapshot converts in bf16, never widened: equal to the fp32
    snapshot's conversion rounded to bf16."""
    sd = tw.synth_hunyuan_sd(JH.tiny(), np.random.default_rng(21))
    tdir = tmp_path / "transformer"
    tdir.mkdir()
    st_save_file({k: t(v).to(torch.bfloat16) for k, v in sd.items()},
                 str(tdir / "model.safetensors"))
    (tdir / "config.json").write_text(json.dumps(HUNYUAN_JSON))
    _, model = pre.load_transformer("hunyuan", str(tmp_path), cache=False,
                                    device="cpu")
    c = JH.tiny()
    want = w.convert_hunyuan({k: t(v) for k, v in sd.items()},
                             c.num_dual_blocks, c.num_single_blocks,
                             c.num_refiner_blocks, c.pooled_dim, c.text_dim,
                             place=lambda x: x.to(torch.bfloat16))
    assert_same_state(model.state_dict(), want)


def test_convert_and_cache(tmp_path):
    root = write_snapshot(str(tmp_path), "wan", with_vae=False)
    tdir, cache = os.path.join(root, "transformer"), str(tmp_path / "c")
    first = ck.convert_and_cache("wan", tdir, cache, num_blocks=2)
    assert ck.has_params(cache)
    assert_same_state(ck.convert_and_cache("wan", tdir, cache, num_blocks=2),
                      first)
    assert_same_state(ck.load_params(cache, use_mmap=False), first)


def test_load_vae_matches_jax(tmp_path):
    root = write_snapshot(str(tmp_path), "hunyuan")
    jencode, jdecode = jpre.load_vae(root)
    encode, decode = pre.load_vae(root, device="cpu")
    g = np.random.default_rng(8)
    lat = g.standard_normal((1, 4, 2, 6, 6)).astype(np.float32)
    want = np.asarray(jdecode(jnp.asarray(lat)))
    got = decode(t(lat))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **VAE_TOL)
    pix = np.clip(want, -1, 1)
    np.testing.assert_allclose(encode(t(pix)).numpy(),
                               np.asarray(jencode(jnp.asarray(pix))),
                               **VAE_TOL)
    assert pre.load_vae(str(tmp_path / "transformer"), device="cpu") == \
        (None, None)
    dec_only = write_snapshot(str(tmp_path / "d"), "hunyuan", encoder=False)
    enc_none, dec = pre.load_vae(dec_only, device="cpu")
    assert enc_none is None and jpre.load_vae(dec_only)[0] is None
    np.testing.assert_allclose(dec(t(lat)).numpy(), want, **VAE_TOL)


def test_loaders_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    root = write_snapshot(str(tmp_path), "wan")
    for call in (lambda: pre.load_transformer("wan", root),
                 lambda: pre.load_vae(root),
                 lambda: pre.load_text_encoders("wan", root),
                 lambda: enc.HashEncoder(8, 16),
                 lambda: __import__(
                     "rectified_spaattn_tpu_torch.pipelines",
                     fromlist=["build_site"]).build_site(
                         2, 4, 4, sa_drop_rate=0.5, p_remain=0.5,
                         layout="visual")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -------------------------------------------------------------------- CLI ---

CLI_ARGS = {
    "hunyuan": ["--height", "64", "--width", "128", "--frame", "8",
                "--num_steps", "2"],
    "wan21-t2v": ["--height", "64", "--width", "64", "--frame", "5",
                  "--num_steps", "2"],
}


def run_both(model, root, out_dir, monkeypatch, extra=()):
    """The JAX CLI's _generate and the port's main on the same snapshot:
    the same noise (JAX's PRNGKey(seed) draw handed to the port), the same
    pseudo-text (the port's, handed to JAX), the JAX side loading fp32
    without writing its cache.  Returns (port result line, port pixels
    [F, H, W, 3] float, JAX pixels)."""
    argv = ["--model", model, "--ckpt_dir", root, *CLI_ARGS[model], *extra]
    jload = jpre.load_transformer
    monkeypatch.setattr(jpre, "load_transformer", lambda f, r, **k: jload(
        f, r, dtype="float32", cache=False))
    monkeypatch.setattr(jgen, "_random_text", lambda p, n, d, batch=1: tuple(
        jnp.asarray(x.numpy()) for x in gen._random_text(p, n, d, batch)))
    jargs = jgen.parse_args(argv)
    drop, tea = jgen.DEFAULTS[model]
    jargs.sa_drop_rate, jargs.teacache_thresh = drop, tea
    want, jpipe = jgen._generate(jargs)
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jargs.seed),
        (1, 4, *jpipe.grid), jnp.float32))

    cls = type(jpipe).__name__
    from rectified_spaattn_tpu_torch import pipelines
    port_cls = getattr(pipelines, cls)
    call = port_cls.__call__
    monkeypatch.setattr(port_cls, "__call__", lambda self, *a, generator=None,
                        **k: call(self, *a, init_latents=t(noise), **k))
    saved = {}
    save = video.save_video
    monkeypatch.setattr(video, "save_video", lambda frames, path, fps=24: (
        saved.setdefault("frames", frames), save(frames, path, fps))[1])
    res = gen.main(argv + ["--device", "cpu", "--out_dir", out_dir])
    monkeypatch.undo()
    return res, saved["frames"], np.asarray(want)


@pytest.mark.parametrize("model", ["hunyuan", "wan21-t2v"])
def test_cli_ckpt_dir_decodes_the_pixels_of_jax(model, tmp_path,
                                                monkeypatch):
    root = write_snapshot(str(tmp_path / "snap"),
                          "hunyuan" if model == "hunyuan" else "wan")
    res, frames, want = run_both(model, root, str(tmp_path / "out"),
                                 monkeypatch)
    assert want.shape[:2] == (1, 3)
    np.testing.assert_allclose(frames, want[0].transpose(1, 2, 3, 0),
                               **PIPE_TOL)
    out = res["output"]
    assert os.path.exists(out) and out.endswith((".mp4", ".npy"))
    if out.endswith(".npy"):      # imageio without its ffmpeg backend
        np.testing.assert_array_equal(np.load(out),
                                      video.to_uint8(frames))
    assert res["decode_seconds"] >= 0
    assert res["teacache"] == {"skipped": 0, "computed": 0}


def test_cli_writes_mp4_and_npy(tmp_path, monkeypatch):
    """With an imageio writer (a stand-in module: an imageio without its
    ffmpeg backend cannot write mp4), the CLI writes .mp4; with imageio
    unimportable, the uint8 frames as .npy."""
    root = write_snapshot(str(tmp_path / "snap"), "hunyuan")
    got = {}

    class Writer:
        def __init__(self, path, **kw):
            got.update(path=path, kw=kw, frames=[])

        def append_data(self, f):
            got["frames"].append(f)

        def close(self):
            open(got["path"], "wb").close()

    fake = types.ModuleType("imageio")
    fake.v2 = types.SimpleNamespace(get_writer=Writer)
    monkeypatch.setitem(sys.modules, "imageio", fake)
    monkeypatch.setitem(sys.modules, "imageio.v2", fake.v2)
    argv = ["--model", "hunyuan", "--ckpt_dir", root, "--device", "cpu",
            *CLI_ARGS["hunyuan"]]
    res = gen.main(argv + ["--out_dir", str(tmp_path / "a")])
    assert res["output"].endswith(".mp4") and os.path.exists(res["output"])
    assert got["kw"] == {"fps": 24, "codec": "libx264", "quality": 8}
    frames = np.stack(got["frames"])
    assert frames.dtype == np.uint8 and frames.shape == (3, 16, 32, 3)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.delitem(sys.modules, "imageio.v2")
    res = gen.main(argv + ["--out_dir", str(tmp_path / "b")])
    assert res["output"].endswith(".npy")
    np.testing.assert_array_equal(np.load(res["output"]), frames)


def test_cli_trace_out_profile_and_refusals(tmp_path):
    trace, prof = tmp_path / "trace.json", tmp_path / "prof"
    res = gen.main(["--device", "cpu", "--scale", "0.05", "--height", "64",
                    "--width", "64", "--frame", "8", "--num_steps", "3",
                    "--enable_teacache", "--trace_out", str(trace),
                    "--profile", str(prof), "--out_dir", str(tmp_path)])
    records = json.loads(trace.read_text())
    assert "meta" in records[0] and len(records) == 1 + 3
    assert res["teacache"]["computed"] == sum(
        r["compute"] for r in records[1:])
    assert os.path.exists(prof / "trace.json")
    assert res["output"].endswith(".npy")          # latents without a VAE
    # --image is ported (tests/test_torch_i2v.py); the TPU levers are
    # still refused, before anything is built
    with pytest.raises(NotImplementedError, match="--scan_blocks"):
        gen.main(["--device", "cpu", "--scan_blocks"])


# ---------------------------------------------------------- video, encoders ---

def test_video_and_image_writers_match_jax(tmp_path, monkeypatch):
    g = np.random.default_rng(4)
    for frames in (g.uniform(-1, 1, (2, 4, 6, 3)), g.uniform(0, 1, (2, 4, 6,
                                                                     3))):
        np.testing.assert_array_equal(video.to_uint8(frames),
                                      jvideo.to_uint8(frames))
    img = g.uniform(-1, 1, (4, 6, 3)).astype(np.float32)
    path = video.save_image(img, str(tmp_path / "a.png"))
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  jvideo.to_uint8(img[None])[0])
    monkeypatch.setitem(sys.modules, "PIL", None)
    alt = video.save_image(img, str(tmp_path / "b.png"))
    assert alt.endswith(".npy")
    np.testing.assert_array_equal(np.load(alt), jvideo.to_uint8(img[None])[0])


def test_hash_encoder_matches_jax():
    ours, theirs = enc.HashEncoder(8, 16, "cpu"), jenc.HashEncoder(8, 16)
    for prompt in ("several hot air balloons", ""):
        e, m = ours(prompt, batch=2)
        je, jm = theirs(prompt, batch=2)
        np.testing.assert_array_equal(e.numpy(), je)
        np.testing.assert_array_equal(m.numpy(), jm)
        np.testing.assert_array_equal(ours.pooled(prompt, 5).numpy(),
                                      theirs.pooled(prompt, 5))
    assert isinstance(enc.make_text_encoder(None, 8, 16, device="cpu"),
                      enc.HashEncoder)
    te = enc.make_text_encoder("/nowhere", 8, 16, "clip", device="cpu")
    assert isinstance(te, enc.TransformersTextEncoder) and te.kind == "clip"


WORDS = "several hot air balloons flying over a city .".split()


def tiny_text_model(kind, path):
    """A tiny transformers text model built from a config, with a
    WordLevel tokenizer, saved to ``path`` (nothing downloaded)."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"[PAD]": 0, "[UNK]": 1, **{x: i + 2 for i, x in
                                        enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]",
        model_input_names=["input_ids", "attention_mask"])
    torch.manual_seed(0)
    small = dict(vocab_size=16, hidden_size=16, intermediate_size=32,
                 num_hidden_layers=1, num_attention_heads=2)
    if kind == "clip":
        model = transformers.CLIPTextModel(transformers.CLIPTextConfig(
            max_position_embeddings=80, projection_dim=8, pad_token_id=0,
            bos_token_id=0, eos_token_id=2, **small))
    elif kind == "llama":
        model = transformers.LlamaModel(transformers.LlamaConfig(
            num_key_value_heads=2, max_position_embeddings=32, **small))
    else:
        model = transformers.T5EncoderModel(transformers.T5Config(
            vocab_size=16, d_model=16, d_kv=8, d_ff=32, num_layers=1,
            num_heads=2))
    model.save_pretrained(path)
    fast.save_pretrained(path)
    return model.eval()


@pytest.mark.parametrize("kind", ["clip", "llama"])
def test_transformers_encoder_matches_jax(kind, tmp_path):
    tiny_text_model(kind, str(tmp_path))
    ours = enc.TransformersTextEncoder(str(tmp_path), 6, kind, device="cpu")
    theirs = jenc.TransformersTextEncoder(str(tmp_path), 6, kind)
    e, m = ours("hot air balloons", batch=2)
    je, jm = theirs("hot air balloons", batch=2)
    assert e.shape == (2, 6, 16) and m.dtype == torch.bool
    np.testing.assert_array_equal(e.numpy(), je)
    np.testing.assert_array_equal(m.numpy(), jm)
    assert m.sum().item() == 2 * 3 and not e[:, 3:].any()
    if kind == "clip":
        np.testing.assert_array_equal(ours.pooled("a city").numpy(),
                                      theirs.pooled("a city"))


def test_t5_encoder_runs_its_encoder_stack(tmp_path):
    """The port loads T5 as T5EncoderModel; JAX's wrapper loads AutoModel
    (T5Model, which needs decoder inputs) and fails on a T5 directory."""
    model = tiny_text_model("t5", str(tmp_path))
    ours = enc.TransformersTextEncoder(str(tmp_path), 6, "t5", device="cpu")
    e, m = ours("a city .")
    ids = torch.tensor([[8, 9, 10, 0, 0, 0]])
    with torch.no_grad():
        want = model(input_ids=ids,
                     attention_mask=(ids != 0).long()).last_hidden_state
    torch.testing.assert_close(e, want * m[..., None], rtol=0, atol=0)
    with pytest.raises(ValueError):
        jenc.TransformersTextEncoder(str(tmp_path), 6, "t5")("a city .")


def test_load_text_encoders_reads_the_tokenizer_dirs(tmp_path):
    """A diffusers snapshot keeps each tokenizer in its own folder."""
    for sub, kind in (("text_encoder", "llama"), ("text_encoder_2", "clip")):
        tiny_text_model(kind, str(tmp_path / sub))
        tok = "tokenizer" + sub[len("text_encoder"):]
        os.makedirs(tmp_path / tok)
        for f in os.listdir(tmp_path / sub):
            if f.startswith(("tokenizer", "special")):
                os.replace(tmp_path / sub / f, tmp_path / tok / f)
    encs = pre.load_text_encoders("hunyuan", str(tmp_path), device="cpu")
    assert [(e.kind, e.max_len) for e in encs] == [("llama", 256),
                                                   ("clip", 77)]
    assert encs[1].tokenizer_dir == str(tmp_path / "tokenizer_2")
    e, m = encs[0]("hot air")
    assert e.shape == (1, 256, 16) and int(m.sum()) == 2
    assert encs[1].pooled("hot air").shape == (1, 16)
    assert [e.kind for e in pre.load_text_encoders(
        "wan", str(tmp_path), device="cpu")] == ["umt5"]
    os.makedirs(tmp_path / "bare")
    assert pre.load_text_encoders("wan", str(tmp_path / "bare"),
                                  device="cpu") == []
