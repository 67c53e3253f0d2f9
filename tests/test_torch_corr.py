"""Kernel 2, the corr-volume window lookup: the port's pyramid and plain
lookup against codd_tpu's volume pyramid, its ``select="reduce"`` lookup
(the eval default) and the Pallas ``window_select`` in interpret mode.
The CUDA kernel is held against the plain version in test_torch_gpu.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from codd_tpu.ops import corr as jcorr
from codd_torch.ops import corr as tcorr
from codd_torch.ops import kernels


def _bf16_to_torch(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _setup(B=2, h=8, w=16, C=32, seed=0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, h, w, C).astype(np.float32)
    f2 = rng.randn(B, h, w, C).astype(np.float32)
    # targets around the identity, some far outside the level
    coords = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
              + rng.uniform(-6, 6, (B, h, w, 2))).astype(np.float32)
    coords[:, 0, 0] = (-9.0, 3.0)
    coords[:, 1, 1] = (w + 8.5, h + 8.5)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                  impl="volume", radius=3)
    return f1, f2, coords, jp


def test_pyramid_matches_volume_impl():
    """bf16 volumes from an f32-accumulated product: the f32 sums run in
    another order, so an element may round to the neighbouring bf16 value
    (1 ulp = 2^-8 relative); everything else is bit-equal."""
    f1, f2, _, jp = _setup()
    vols = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                    torch.from_numpy(f2), 4, 3)
    assert len(vols) == len(jp["vols"]) == 4
    for tv, jv in zip(vols, jp["vols"]):
        jv = np.asarray(jv).astype(np.float32)
        assert tuple(tv.shape) == jv.shape and tv.dtype == torch.bfloat16
        d = np.abs(tv.float().numpy() - jv)
        assert (d <= 2.0 ** -8 * np.abs(jv) + 1e-30).all()
        assert (d > 0).mean() < 0.01


@pytest.mark.parametrize("level", [0, 1, 3])
def test_plain_lookup_matches_reduce_and_pallas(level):
    """On the same bf16 volume the port's taps are the same bf16 values
    and the bilinear combine the same arithmetic: agreement to f32
    rounding (atol 1e-6)."""
    _, _, coords, jp = _setup(seed=level)
    jvol = jp["vols"][level]
    jc = jnp.asarray(coords) / (2 ** level)
    ref = np.asarray(jcorr._lookup_level_volume(jvol, jc, 3, select="reduce"))
    pal = np.asarray(jcorr._lookup_level_volume(jvol, jc, 3, select="pallas"))
    got = tcorr.corr_lookup_level_plain(_bf16_to_torch(jvol),
                                        torch.from_numpy(coords) / 2 ** level,
                                        3).numpy()
    assert got.shape == ref.shape == coords.shape[:3] + (49,)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, pal, atol=1e-6, rtol=0)


def test_corr_lookup_all_levels():
    """The whole lookup on each side's own pyramid: the volumes may differ
    by 1 bf16 ulp, so atol is 2^-8 of the largest correlation."""
    f1, f2, coords, jp = _setup(B=1, h=6, w=20, seed=4)
    ref = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(coords), 3,
                                       select="reduce"))
    vols = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                    torch.from_numpy(f2), 4, 3)
    before = kernels.counts()["corr_lookup"]
    got = tcorr.corr_lookup(vols, torch.from_numpy(coords), 3).numpy()
    assert kernels.counts()["corr_lookup"] == before  # CPU: plain version
    assert got.shape == ref.shape == (1, 6, 20, 196)
    scale = max(float(np.abs(np.asarray(v, np.float32)).max())
                for v in jp["vols"])
    np.testing.assert_allclose(got, ref, atol=2.0 ** -8 * scale, rtol=0)
