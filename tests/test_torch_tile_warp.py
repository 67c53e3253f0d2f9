"""Kernel 1, the tile-warp cost: the port's plain version against
codd_tpu's XLA oracle (hitnet.tile_warping) and the Pallas kernel in
interpret mode, on the same numpy inputs.  The CUDA kernel is held
against the plain version on the card in test_torch_gpu.py.

Tolerance rel 1e-5 of max|cost|: the sample positions and their floor()
are computed with the same operations in the same order, so the taps
agree; only the order of the C-term L1 sums differs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from codd_tpu.models.stereo.hitnet import tile_warping
from codd_tpu.ops.pallas.tile_warp import tile_warp_cost as pallas_tile_warp
from codd_torch.ops import kernels
from codd_torch.ops.tile_warp import tile_warp_cost, tile_warp_cost_plain


def _inputs(B, H, W, C, seed=0, max_d=None):
    rng = np.random.RandomState(seed)
    fl = rng.randn(B, H, W, C).astype(np.float32)
    fr = rng.randn(B, H, W, C).astype(np.float32)
    ht, wt = H // 4, W // 4
    max_d = W * 0.8 if max_d is None else max_d
    hyp3 = np.stack([rng.rand(B, ht, wt) * max_d,
                     rng.uniform(-1.2, 1.2, (B, ht, wt)),
                     rng.uniform(-1.2, 1.2, (B, ht, wt))], -1)
    return hyp3.astype(np.float32), fl, fr


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (
        np.abs(np.asarray(b)).max() + 1e-9)


@pytest.mark.parametrize("shape,max_d", [
    ((1, 16, 64, 16), None),      # the full-res level's C
    ((2, 16, 32, 24), None),      # batched, the 1/8 and 1/4 levels' C
    ((1, 8, 64, 32), 90.0),       # coarsest level's C; taps off both edges
])
def test_plain_matches_xla_and_pallas(shape, max_d):
    hyp3, fl, fr = _inputs(*shape, max_d=max_d)
    got = tile_warp_cost_plain(*(torch.from_numpy(a) for a in (hyp3, fl, fr)))
    ref = np.asarray(tile_warping(jnp.asarray(hyp3), jnp.asarray(fl),
                                  jnp.asarray(fr)))
    pal = np.asarray(pallas_tile_warp(jnp.asarray(hyp3), jnp.asarray(fl),
                                      jnp.asarray(fr), interpret=True))
    assert got.shape == ref.shape == (shape[0], shape[1] // 4,
                                      shape[2] // 4, 48)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, pal) < 1e-5


def test_wrapper_uses_plain_version_on_cpu():
    hyp3, fl, fr = (torch.from_numpy(a) for a in _inputs(1, 8, 32, 16))
    before = kernels.counts()["tile_warp_cost"]
    out = tile_warp_cost(hyp3, fl, fr)
    assert torch.equal(out, tile_warp_cost_plain(hyp3, fl, fr))
    assert kernels.counts()["tile_warp_cost"] == before

