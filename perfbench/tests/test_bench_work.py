"""The frozen work counts give PERF.md section 6's bound column at its
shapes (chip_smoke.py phase 3's inputs), to the digits printed there."""

import pytest
import torch

from perfbench.harness import work

H, W = 384, 1280


def ms(arith, *args):
    nbytes, flops = arith(*args)
    return work.bound_s(nbytes, flops) * 1e3


def test_tile_warp_cost():
    hyp3 = torch.zeros(1, H // 4, W // 4, 3)
    f = torch.zeros(1, H, W, 16)
    assert ms(work.tile_warp_cost, hyp3, f, f) == pytest.approx(0.0207, abs=5e-5)


def test_corr_lookup():
    coords = torch.zeros(1, H // 8, W // 8, 2)
    vols = [None] * 4
    assert ms(work.corr_lookup_levels, vols, coords) == pytest.approx(0.0030, abs=5e-5)


def test_gn_fused_solve():
    ae = torch.zeros(1, H // 8, W // 8, 32)
    assert ms(work.gn_fused_solve, ae, torch.zeros(1, H // 8, W // 8, 27)) == pytest.approx(
        0.0109, abs=5e-5)
