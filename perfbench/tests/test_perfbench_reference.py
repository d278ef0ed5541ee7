"""The plain reference against the port at tiny sizes on the CPU, piece
by piece: the curve and neighbour mask, and the rectified site (plan mask
and output) on float32 inputs with a padded visual region."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import common, curve, sparse
from rectified_spaattn_tpu_torch.curves import gilbert
from rectified_spaattn_tpu_torch.pipelines.base import build_site
from rectified_spaattn_tpu_torch.attention.rectified import (
    rectified_sparse_attention)
from rectified_spaattn_tpu_torch.sparse import pipeline as plan_mod


@pytest.mark.parametrize("grid", [(3, 8, 15), (6, 12, 20)])
def test_curve_and_neighbours(grid):
    l2c, c2l = curve.gilbert_mapping(*grid)
    want_l2c, want_c2l = gilbert.gilbert_mapping(*grid)
    assert (l2c == want_l2c).all() and (c2l == want_c2l).all()
    assert (curve.block_neighbors(l2c, *grid)
            == gilbert.gilbert_block_neighbor_mask(*grid)).all()


@pytest.mark.parametrize("grid,group", [((2, 8, 15), 2), ((4, 8, 16), 1)])
def test_site_matches_the_port(grid, group, monkeypatch):
    torch.manual_seed(0)
    h, d, text_len, tlen = 2, 32, 128, 90
    site, _, _ = build_site(*grid, sa_drop_rate=0.8, p_remain=0.3,
                            layout="joint", text_len=text_len,
                            group_rows=group, device="cpu")
    sv = site.visual_len
    # smooth rows, so that the plan has structure to find
    base = torch.randn(1, h, sv // 16 + 1, d).repeat_interleave(16, dim=2)
    q, k, v = ((base[:, :, :sv] + 0.3 * torch.randn(1, h, sv, d)).float()
               for _ in range(3))
    q, k, v = (torch.cat([x, torch.randn(1, h, text_len, d)], dim=2)
               for x in (q, k, v))
    masks = []
    orig = plan_mod.build_sparse_plan

    def keep(*a, **kw):
        p = orig(*a, **kw)
        masks.append(p.block_mask)
        return p
    import rectified_spaattn_tpu_torch.attention.rectified as rect
    monkeypatch.setattr(rect, "build_sparse_plan", keep)
    want = rectified_sparse_attention(
        q, k, v, site.cfg, site.neighbor_mask, visual_len=sv,
        text_len_rt=torch.tensor([tlen], dtype=torch.int32))
    floor = int(0.2 * (sv // 128))
    got, mask = sparse.rectified_attention(
        q[0], k[0], v[0], common.Numerics({}), visual_len=sv,
        text_len=text_len, tlen=tlen, neighbors=site.neighbor_mask,
        p_remain=0.3, floor=floor, rows_per_step=3)
    assert torch.equal(mask, masks[0][0])
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=1e-4,
                               atol=1e-5)
