"""What the end-to-end bench tests share (tests/test_torch_e2e*.py):
the JAX scripts of scripts/ loaded through importlib (never edited), their
samplers and the port's cut to small pools, and the tolerances."""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rectified_spaattn_tpu_torch.bench import e2e_weights as ew

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-4)
F32 = dict(rtol=2e-4, atol=2e-5)
POOL = 10          # the small pools: 1,024 values, so that windows wrap
BYTE_POOL = 11


def script(name: str):
    """scripts/<name>.py as the module ``name`` (the bench_e2e_* scripts
    import bench_e2e by that name)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


class _SmallByteNumpy:
    """numpy for host_quantized_tree with its byte pool cut to
    2^BYTE_POOL (the script hard-codes 2^25)."""

    def __getattr__(self, name):
        return getattr(np, name)

    class random:
        class default_rng:
            def __init__(self, seed):
                self.g = np.random.default_rng(seed)

            def integers(self, lo, hi, size, dtype):
                return self.g.integers(lo, hi, size=min(size, 1 << BYTE_POOL),
                                       dtype=dtype)

            def __getattr__(self, name):
                return getattr(self.g, name)


@pytest.fixture
def small_pools(monkeypatch):
    """The scripts' samplers at the small pools (bench_e2e.py's module
    globals, which bench_e2e_wan / bench_e2e_flux import by name)."""
    be = script("bench_e2e")
    orig = be.pool_normal_sampler
    monkeypatch.setattr(be, "pool_normal_sampler",
                        lambda seed, scale, pool_bits=26: orig(
                            seed, scale, pool_bits=POOL))
    monkeypatch.setattr(be, "np", _SmallByteNumpy())
    return be


@pytest.fixture
def small_port_pools(monkeypatch):
    """The port benches' pooled trees at the small pool too."""
    orig = ew.random_bf16_model
    monkeypatch.setattr(ew, "random_bf16_model", lambda *a, **kw: orig(
        *a, **{**kw, "pool_bits": POOL}))


def f32_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def noise(shape, seed=1):
    """The port pipelines' initial noise: a CPU generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).numpy()
