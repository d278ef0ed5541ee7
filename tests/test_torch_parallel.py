"""The port's multi-device path against the JAX package on the CPU: K1s (the
plain K1 with return_stats), the ring sequence-parallel attention, the
head-parallel site, the tensor-parallel HunyuanVideo and Wan pipelines and
``--tp`` in the CLI.  Same numpy inputs; the JAX side runs as its own tests
run it (Pallas in interpret mode, sp = 4 over the 8 virtual CPU devices of
tests/conftest.py).

Tolerances: K1s fp32 rtol 2e-4 / atol 2e-5 (tests/test_kernels.py), with
m == -inf and l == 0 exactly where JAX's are; the visual ring at fp32 rtol
2e-4 / atol 2e-5 against the JAX ring.  One JAX joint-ring call costs about
a minute here, so the joint ring (and the visual ring without first-frame
blocks) is held against JAX's single-device rectified_sparse_attention at
2e-3, the tolerance at which tests/test_parallel.py holds the JAX ring to
it.  The head-parallel site and the tp = 2 pipelines: 2e-3 against the JAX
single-device ones (tests/test_parallel.py:288,315).

Multi-process cases spawn gloo ranks with a file:// rendezvous under
tmp_path (tests/_torch_dist_workers.py, which imports no JAX); the ring
runs through the in-process group and through gloo, which agree bit for
bit; the head split runs on gloo."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

from rectified_spaattn_tpu import kernels as jk
from rectified_spaattn_tpu.attention import (
    rectified_sparse_attention as j_rectified)
from rectified_spaattn_tpu.attention.ring import (
    ring_rectified_sparse_attention as j_ring)
from rectified_spaattn_tpu.cache import teacache as jtc
from rectified_spaattn_tpu.models import quant as jq
from rectified_spaattn_tpu.models.hunyuan import (
    HunyuanVideoConfig as JHConfig, HunyuanVideoDiT as JHDiT)
from rectified_spaattn_tpu.models.wan import WanConfig as JWConfig
from rectified_spaattn_tpu.models.wan import WanDiT as JWDiT
from rectified_spaattn_tpu.pipelines import HunyuanVideoPipeline as JHPipe
from rectified_spaattn_tpu.pipelines import WanPipeline as JWPipe
from rectified_spaattn_tpu.sparse import SparseConfig as JConfig
from rectified_spaattn_tpu.sparse import ops as jops
from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.attention import (
    ring_rectified_sparse_attention)
from rectified_spaattn_tpu_torch.models import flax_to_state_dict
from rectified_spaattn_tpu_torch.parallel import in_process_mesh
from rectified_spaattn_tpu_torch.sparse import SparseConfig, ops

import _torch_dist_workers as workers

torch.set_num_threads(1)
BM = BN = 128
F32 = dict(rtol=2e-4, atol=2e-5)
SITE = dict(rtol=2e-3, atol=2e-3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ K1s ---

def k1s_case(case):
    """(q, k, v, mask, text_len, kwargs) of one K1s case."""
    if case == "random":
        q, k, v = arr(1, 2, 2, 3 * BM, 64), arr(2, 2, 2, 5 * BN, 64), \
            arr(3, 2, 2, 5 * BN, 64)
        mask = np.random.default_rng(4).uniform(size=(2, 2, 3, 5)) < 0.5
        mask[..., 0] = True
        return q, k, v, mask, [0, 0], dict(visual_len=5 * BN, text_start=None)
    if case == "count0":
        q, k, v = arr(5, 1, 2, 3 * BM, 64), arr(6, 1, 2, 4 * BN, 64), \
            arr(7, 1, 2, 4 * BN, 64)
        mask = np.zeros((1, 2, 3, 4), bool)
        mask[:, :, 0, :2] = True
        mask[:, 1, 2, 3] = True
        return q, k, v, mask, [0], dict(visual_len=4 * BN, text_start=None)
    if case.startswith("degenerate"):
        # a row whose only block is the text block of a batch with no
        # valid text: V averaged over its chunk's lanes, m = MASK_VALUE
        q, k, v = arr(8, 1, 2, 3 * BM, 64), arr(9, 1, 2, 4 * BN, 64), \
            arr(10, 1, 2, 4 * BN, 64)
        mask = np.random.default_rng(11).uniform(size=(1, 2, 3, 4)) < 0.5
        mask[..., 0] = True
        mask[0, 1, 1] = False
        mask[0, 1, 1, 3] = True
        return q, k, v, mask, [0], dict(
            visual_len=3 * BN, text_start=3 * BN,
            chunk_blocks=int(case.rsplit("_", 1)[1]))
    if case == "text_window_b2":
        q, k, v = arr(12, 2, 2, 3 * BM, 64), arr(13, 2, 2, 4 * BN, 64), \
            arr(14, 2, 2, 4 * BN, 64)
        mask = np.random.default_rng(15).uniform(size=(2, 2, 3, 4)) < 0.6
        mask[..., -1] = True
        return q, k, v, mask, [100, 37], dict(visual_len=3 * BN - 40,
                                              text_start=3 * BN)
    assert case == "packed_kv"
    q, k, v = arr(16, 1, 2, 2 * BM, 32), arr(17, 1, 2, 6 * BN, 32), \
        arr(18, 1, 2, 6 * BN, 32)
    mask = np.random.default_rng(19).uniform(size=(1, 2, 2, 6)) < 0.4
    mask[0, 0, 1] = False                               # count 0
    return q, k, v, mask, [0], dict(visual_len=6 * BN, text_start=None,
                                    packed=True)


@pytest.mark.parametrize("case", ["random", "count0", "degenerate_2",
                                  "degenerate_16", "text_window_b2",
                                  "packed_kv"])
def test_k1s_plain_matches_jax_stats(case):
    """o, m and l of the plain K1s against the JAX kernel with
    return_stats; m == -inf and l == 0 exactly on count-0 rows."""
    q, k, v, mask, tlen, kw = k1s_case(case)
    packed = kw.pop("packed", False)
    idx, cnt = ops.mask_to_indices(t(mask))
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    tl = torch.tensor(tlen, dtype=torch.int32)
    tkv = t(np.concatenate([k, v], -1)) if packed else None
    jkv = jnp.asarray(np.concatenate([k, v], -1)) if packed else None
    got = tk.block_sparse_flash_attention(
        t(q), t(k), t(v), idx, cnt, tl, return_stats=True, packed_kv=tkv,
        **kw)
    want = jk.block_sparse_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jidx, jcnt,
        jnp.asarray(tlen, jnp.int32), interpret=True, return_stats=True,
        packed_kv=jkv, **kw)
    for g, w, name in zip(got, want, "oml"):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
    m, l = got[1].numpy(), got[2].numpy()
    zero = np.repeat(cnt.numpy() == 0, BM, axis=-1)
    np.testing.assert_array_equal(np.asarray(want[1])[zero], -np.inf)
    np.testing.assert_array_equal(m[zero], -np.inf)
    np.testing.assert_array_equal(l[zero], 0.0)
    np.testing.assert_array_equal(got[0].numpy()[zero], 0.0)
    if case == "count0":
        assert zero.any()
    if case.startswith("degenerate"):
        assert m[0, 1, BM] == tk.block_sparse.MASK_VALUE
        assert l[0, 1, BM] == kw["chunk_blocks"] * BN


# ----------------------------------------------------------------- ring ---

RING = dict(b=1, h=2, d=32, s=8 * BN, t=128, tlen=90)


def ring_inputs():
    g = np.random.default_rng(13)
    b, h, d, s, tt = (RING[n] for n in ("b", "h", "d", "s", "t"))
    q, k, v = (g.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    qt, kt, vt = (g.normal(size=(b, h, tt, d)).astype(np.float32)
                  for _ in range(3))
    return q, k, v, qt, kt, vt, np.eye(s // BN, dtype=bool)


def ring_cfg(layout, ffb, **kw):
    base = dict(top_k_floor=1, p_remain=0.4, layout=layout,
                first_frame_blocks=ffb, **kw)
    if layout == "joint":
        base.update(text_len=RING["t"], topp_impl="sort")
    return base


RING_CASES = [("visual", 0), ("visual", 1), ("joint", 0), ("joint", 1)]


def spawn(fn, world, tmp):
    """Start ``world`` gloo ranks of ``fn`` without waiting; ``join(ctx)``
    waits for them (and raises a rank's error)."""
    return mp.start_processes(fn, args=(world, str(tmp)), nprocs=world,
                              join=False, start_method="spawn")


def join(ctx, timeout: float = 300.0):
    """Wait for the ranks (the gloo timeout inside them is 180 s); past
    ``timeout`` kill them and fail."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"gloo ranks still running after {timeout} s")


def gloo_ring_cases():
    q, k, v, qt, kt, vt, nbr = ring_inputs()
    text = dict(q_text=t(qt), k_text=t(kt), v_text=t(vt),
                text_len_rt=torch.tensor([RING["tlen"]], dtype=torch.int32))
    cases = {
        "visual": dict(cfg=ring_cfg("visual", 1)),
        "joint": dict(cfg=ring_cfg("joint", 1), **text),
        "joint_packed_chunk": dict(cfg=ring_cfg("joint", 0,
                                                plan_row_chunk=1),
                                   kv_packed=t(np.concatenate([k, v], -1)),
                                   **text),
    }
    for c in cases.values():
        c.update(q=t(q), k=t(k), v=t(v), nbr=t(nbr))
    return cases


@pytest.fixture(scope="module")
def ring_gloo(tmp_path_factory):
    """The ring on gloo, 4 ranks, started before the JAX references are
    computed so that the two overlap."""
    tmp = tmp_path_factory.mktemp("ring_gloo")
    cases = gloo_ring_cases()
    torch.save(cases, tmp / "ring_in.pt")
    ctx = spawn(workers.ring_worker, 4, tmp)
    yield ctx, tmp, cases
    join(ctx)                      # no rank outlives the module


@pytest.fixture(scope="module")
def ring_refs(ring_gloo):
    """JAX references, each computed once: the JAX ring (sp = 4) for the
    visual layout with first-frame blocks; JAX's single-device site for
    every case."""
    from jax.sharding import Mesh
    q, k, v, qt, kt, vt, nbr = ring_inputs()
    jn = jnp.asarray(nbr)
    tlen = jnp.asarray([RING["tlen"]], jnp.int32)
    refs = {}
    for layout, ffb in RING_CASES:
        cfg = JConfig(**ring_cfg(layout, ffb))
        if layout == "visual":
            refs[layout, ffb] = np.asarray(j_rectified(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg, jn,
                visual_len=RING["s"], interpret=True))
        else:
            cat = lambda a, b: jnp.asarray(np.concatenate([a, b], 2))
            refs[layout, ffb] = np.asarray(j_rectified(
                cat(q, qt), cat(k, kt), cat(v, vt), cfg, jn,
                visual_len=RING["s"], text_len_rt=tlen, interpret=True))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 4),
                ("dp", "tp", "sp"))
    refs["jax_ring"] = np.asarray(j_ring(
        mesh, *map(jnp.asarray, (q, k, v)), JConfig(**ring_cfg("visual", 1)),
        jn, interpret=True))
    return refs


def port_ring(layout, ffb, packed=False, **cfg_kw):
    q, k, v, qt, kt, vt, nbr = ring_inputs()
    cfg = SparseConfig(**ring_cfg(layout, ffb, **cfg_kw))
    kw = {}
    if layout == "joint":
        kw = dict(q_text=t(qt), k_text=t(kt), v_text=t(vt),
                  text_len_rt=torch.tensor([RING["tlen"]], dtype=torch.int32))
    if packed:
        kv = t(np.concatenate([k, v], -1))
        kw["kv_packed"] = kv
        k, v = kv[..., :RING["d"]], kv[..., RING["d"]:]
    else:
        k, v = t(k), t(v)
    return ring_rectified_sparse_attention(in_process_mesh(sp=4), t(q), k, v,
                                           cfg, t(nbr), **kw)


@pytest.mark.parametrize("layout,ffb", RING_CASES)
def test_ring_matches_jax(ring_refs, layout, ffb):
    """The in-process sp = 4 ring against JAX's single-device site (2e-3)
    and, visual with first-frame blocks, against the JAX ring (fp32)."""
    got = port_ring(layout, ffb)
    want = ring_refs[layout, ffb]
    s = RING["s"]
    if layout == "joint":
        vis, txt = got
        np.testing.assert_allclose(vis.numpy(), want[:, :, :s], **SITE)
        np.testing.assert_allclose(txt.numpy(), want[:, :, s:], **SITE)
    else:
        np.testing.assert_allclose(got.numpy(), want, **SITE)
        if ffb:
            np.testing.assert_allclose(got.numpy(), ring_refs["jax_ring"],
                                       **F32)


@pytest.mark.slow
@pytest.mark.parametrize("layout,ffb", [c for c in RING_CASES
                                        if c != ("visual", 1)])
def test_ring_matches_jax_ring_f32(layout, ffb):
    """The in-process sp = 4 ring against the JAX ring at fp32 in the
    cases test_ring_matches_jax holds only to the single-device site: the
    joint ring (JAX ``_ring_joint``) and the visual ring without
    first-frame blocks.  Slow: one JAX joint-ring call takes about a
    minute here."""
    from jax.sharding import Mesh
    q, k, v, qt, kt, vt, nbr = ring_inputs()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 4),
                ("dp", "tp", "sp"))
    kw = {}
    if layout == "joint":
        kw = dict(q_text=jnp.asarray(qt), k_text=jnp.asarray(kt),
                  v_text=jnp.asarray(vt),
                  text_len_rt=jnp.asarray([RING["tlen"]], jnp.int32))
    want = j_ring(mesh, *map(jnp.asarray, (q, k, v)),
                  JConfig(**ring_cfg(layout, ffb)), jnp.asarray(nbr),
                  interpret=True, **kw)
    got = port_ring(layout, ffb)
    if layout == "visual":
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("layout", ["visual", "joint"])
def test_ring_composes_with_packed_kv_and_row_chunk(layout):
    """plan_row_chunk 1 with ONE packed [K|V] buffer rotating the ring
    equals the plain ring (tests/test_parallel.py:178-232: atol 1e-6)."""
    want = port_ring(layout, 1)
    got = port_ring(layout, 1, packed=True, plan_row_chunk=1)
    for g, w in zip(got if layout == "joint" else [got],
                    want if layout == "joint" else [want]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_ring_gloo_equals_in_process(ring_gloo):
    """The ring on gloo (4 processes, each given the global inputs) equals
    the in-process group bit for bit on every rank: the visual and joint
    layouts, and the composed plan_row_chunk + kv_packed ring."""
    ctx, tmp, cases = ring_gloo
    join(ctx)
    outs = [torch.load(tmp / f"ring_out_{r}.pt") for r in range(4)]
    for name, c in cases.items():
        layout = c["cfg"]["layout"]
        want = port_ring(layout, c["cfg"]["first_frame_blocks"],
                         packed="kv_packed" in c,
                         plan_row_chunk=c["cfg"].get("plan_row_chunk", 0))
        for r in range(4):
            got = outs[r][name]
            for g, w in zip(got if layout == "joint" else [got],
                            want if layout == "joint" else [want]):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


# ------------------------------------------------- head parallel and tp ---

def head_parallel_inputs():
    g = np.random.default_rng(12)
    q, k, v = (g.normal(size=(2, 4, 2 * BM, 32)).astype(np.float32)
               for _ in range(3))
    return q, k, v, dict(top_k_floor=1, p_remain=0.4, layout="visual")


@pytest.fixture(scope="module")
def head_parallel_ref():
    q, k, v, cfg = head_parallel_inputs()
    return np.asarray(j_rectified(*map(jnp.asarray, (q, k, v)),
                                  JConfig(**cfg), None, visual_len=2 * BM,
                                  interpret=True))


def hunyuan_pair(bits=0, image_condition_type=None):
    """The tiny JAX HunyuanVideo and its params (quantized with ``bits``:
    min_size 1, as the tiny widths are far below 1 << 20, and int4 groups
    of 32 so that a group divides each tp = 2 shard)."""
    cfg = dataclasses.replace(JHConfig.tiny(),
                              image_condition_type=image_condition_type)
    g = np.random.default_rng(0)
    text = g.normal(size=(1, 128, cfg.text_dim)).astype(np.float32)
    mask = np.zeros((1, 128), bool)
    mask[:, :9] = True
    jmod = JHDiT(cfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.in_channels, 2, 8, 8)),
        jnp.array([0.0]), jnp.asarray(text), jnp.asarray(mask),
        jnp.array([6000.0]), None, None))
    if bits:
        params = jq.quantize_params(params, bits=bits, group_size=32,
                                    min_size=1)
    return jmod, params, text, mask


def wan_pair():
    jcfg = JWConfig.tiny()
    jmod = JWDiT(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), np.zeros((1, jcfg.in_channels, 2, 8, 8),
                                        np.float32),
        np.zeros((1,), np.float32), arr(7, 1, 5, jcfg.text_dim), None))
    return jmod, params


HUNYUAN_KW = dict(height=64, width=128, frames=8, num_steps=3,
                  sa_drop_rate=0.5, p_remain_rates=0.5, mode="sparse",
                  enable_teacache=True, rel_l1_thresh=0.8, text_len=128,
                  group_rows=2)
WAN_KW = dict(height=192, width=240, frames=5, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, mode="sparse", enable_teacache=True,
              teacache_thresh=0.3, warm_layers=1, warm_calls=0)


def jax_decisions(run, tmp_path, name):
    trace = tmp_path / f"{name}.json"
    with jtc.trace_to(str(trace)):
        out = np.asarray(run())
    return out, [r["compute"] for r in json.loads(trace.read_text())
                 if "call" in r]


CLI = ["--model", "hunyuan", "--device", "cpu", "--scale", "0.1",
       "--height", "64", "--width", "64", "--frame", "8", "--num_steps", "2",
       "--enable_teacache", "--group_rows", "2"]


@pytest.fixture(scope="module")
def tp_gloo(tmp_path_factory):
    """Two gloo ranks at tp = 2 (tests/_torch_dist_workers.py::tp_worker)
    and, while they run, the JAX single-device pipelines with their
    TeaCache decisions: (tmp, per-rank outputs, JAX references)."""
    tmp = tmp_path_factory.mktemp("tp_gloo")
    q, k, v, hcfg = head_parallel_inputs()
    inp = {"head_parallel": dict(q=t(q), k=t(k), v=t(v), cfg=hcfg),
           "pipelines": {}}
    runs = {}                    # the JAX pipelines, run once the ranks are
    init_h = np.random.default_rng(4).normal(size=(1, 4, 2, 8, 16)).astype(
        np.float32)
    for name, bits in (("hunyuan", 0), ("hunyuan_int8", 8),
                       ("hunyuan_int4", 4)):
        jmod, params, text, mask = hunyuan_pair(bits)
        jpipe = JHPipe(model=jmod, params=params, interpret=True,
                       **HUNYUAN_KW)
        assert jpipe.grid == init_h.shape[2:]
        runs[name] = (lambda p=jpipe, x=text, m=mask: p(
            jnp.asarray(x), jnp.asarray(m), init_latents=jnp.asarray(init_h)))
        inp["pipelines"][name] = dict(
            kind="hunyuan", state_dict=flax_to_state_dict(params),
            kw=HUNYUAN_KW, text=text, mask=mask, init=init_h)
    # HunyuanVideo I2V (token_replace): the t=0 conditioning and the held
    # first frame under the head split
    jmod, params, text, mask = hunyuan_pair(0, "token_replace")
    jpipe = JHPipe(model=jmod, params=params, interpret=True, **HUNYUAN_KW)
    first = np.random.default_rng(5).normal(
        size=(1, 4, 1, *init_h.shape[3:])).astype(np.float32)
    runs["hunyuan_i2v"] = (lambda p=jpipe, x=text, m=mask: p(
        jnp.asarray(x), jnp.asarray(m), init_latents=jnp.asarray(init_h),
        first_frame=jnp.asarray(first)))
    inp["pipelines"]["hunyuan_i2v"] = dict(
        kind="hunyuan_i2v", state_dict=flax_to_state_dict(params),
        kw=HUNYUAN_KW, text=text, mask=mask, init=init_h, first_frame=first)
    jmod, params = wan_pair()
    jpipe = JWPipe(model=jmod, params=params, interpret=True, **WAN_KW)
    g = np.random.default_rng(14)
    init_w = g.normal(size=(1, 4, *jpipe.grid)).astype(np.float32)
    text_c = g.normal(size=(1, 6, 32)).astype(np.float32)
    text_u = np.zeros_like(text_c)
    runs["wan"] = lambda: jpipe.denoise(
        *map(jnp.asarray, (init_w, text_c, text_u)))
    inp["pipelines"]["wan"] = dict(
        kind="wan", state_dict=flax_to_state_dict(params), kw=WAN_KW,
        init=init_w, text_c=text_c, text_u=text_u)
    inp["cli_argv"] = CLI + ["--tp", "2", "--out_dir", str(tmp / "tp2")]
    torch.save(inp, tmp / "tp_in.pt")
    ctx = spawn(workers.tp_worker, 2, tmp)
    try:
        # the JAX references while the ranks run
        refs = {name: jax_decisions(run, tmp, name)
                for name, run in runs.items()}
    finally:
        join(ctx)
    outs = [torch.load(tmp / f"tp_out_{r}.pt", weights_only=False)
            for r in range(2)]
    return tmp, outs, refs


def test_head_parallel_on_gloo_and_head_count(tp_gloo, head_parallel_ref):
    """At tp = 2 on gloo, every rank's global output equals JAX's
    single-device site; a head count the group does not divide raises the
    JAX ValueError on every rank."""
    _, outs, _ = tp_gloo
    for out in outs:
        np.testing.assert_allclose(out["head_parallel"].numpy(),
                                   head_parallel_ref, **SITE)
        assert "heads % tp == 0" in out["head_count_error"]


def test_tensor_parallel_pipelines_and_cli(tp_gloo):
    """At tp = 2 on gloo: the tiny HunyuanVideo pipeline (dense, int8 and
    int4 QLinears, and I2V token_replace with its first frame held bit for
    bit) and the tiny Wan pipeline against the JAX single-device
    pipelines, TeaCache decisions identical on both ranks and equal to
    JAX's; ``--tp 2 --device cpu`` gives rank 0's output, equal to
    ``--tp 1``."""
    tmp, outs, refs = tp_gloo
    for name, (want, jdec) in refs.items():
        assert False in jdec, name                 # the skip path ran
        for out in outs:
            got = out[name]
            assert got["decisions"] == jdec, name
            assert set(got["heads"]) == {1}, name  # 2 heads over tp = 2
            np.testing.assert_allclose(got["latents"].numpy(), want,
                                       err_msg=name, **SITE)
    first = np.asarray(refs["hunyuan_i2v"][0])[:, :, :1]
    for out in outs:
        np.testing.assert_array_equal(
            out["hunyuan_i2v"]["latents"].numpy()[:, :, :1], first)

    from rectified_spaattn_tpu_torch.cli.generate import main
    assert outs[1]["cli"] is None                  # rank 0 writes alone
    res = outs[0]["cli"]
    one = main(CLI + ["--out_dir", str(tmp / "tp1")])
    assert res["teacache"] == one["teacache"]
    assert os.listdir(tmp / "tp2") == [os.path.basename(res["output"])]
    np.testing.assert_allclose(np.load(res["output"]),
                               np.load(one["output"]), **SITE)
    with pytest.raises(SystemExit, match="--tp 2 but only 1 devices"):
        main(CLI + ["--tp", "2"])


@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 2), (1, 4, 2), (2, 4, 1),
                                      (8, 1, 1)])
def test_mesh_rank_groups_match_jax_devices(dp, tp, sp):
    """Each axis's process groups hold the ranks that the JAX mesh (make_mesh
    over the 8 virtual devices) lines up along that axis."""
    from rectified_spaattn_tpu.parallel import make_mesh as j_make_mesh
    from rectified_spaattn_tpu_torch.parallel.mesh import axis_groups
    jm = j_make_mesh(dp=dp, tp=tp, sp=sp)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)        # [dp, tp, sp]
    groups = axis_groups(dict(zip(jm.axis_names, ids.shape)))
    for a, axis in enumerate(jm.axis_names):
        want = np.moveaxis(ids, a, -1).reshape(-1, ids.shape[a]).tolist()
        assert groups[axis] == want, axis


def test_port_imports_no_jax_in_a_fresh_process():
    """Every module of the port, the multi-device and batch-evaluation
    ones included, imports in a fresh interpreter without loading jax or
    the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import rectified_spaattn_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "need = {'rectified_spaattn_tpu_torch.parallel.mesh', "
        "'rectified_spaattn_tpu_torch.parallel.sharding', "
        "'rectified_spaattn_tpu_torch.parallel.multihost', "
        "'rectified_spaattn_tpu_torch.attention.ring', "
        "'rectified_spaattn_tpu_torch.attention.sharded', "
        "'rectified_spaattn_tpu_torch.eval', "
        "'rectified_spaattn_tpu_torch.eval.diff_metrics', "
        "'rectified_spaattn_tpu_torch.eval.generation', "
        "'rectified_spaattn_tpu_torch.eval.quality', "
        "'rectified_spaattn_tpu_torch.eval.run_eval', "
        "'rectified_spaattn_tpu_torch.curves.__main__', "
        "'rectified_spaattn_tpu_torch.curves.visualize'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'rectified_spaattn_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 69
