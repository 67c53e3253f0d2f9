"""Kernels 2 and 6, the correlation lookups: the port's pyramids and plain
lookups against codd_tpu's volume pyramid with its ``select="reduce"``
lookup (the eval default) and the Pallas ``window_select`` in interpret
mode, and against its ``"patch"`` pyramid with ``_lookup_level`` (the
formulation ``scripts/kernel_corr_pallas.py`` prototypes a TPU kernel
for).  The CUDA kernels are held against the plain versions in
test_torch_gpu.py."""

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


def _patch_setup(seed, B=2, h=8, w=16, C=32):
    """Coords around the identity plus the hard cases: windows wholly
    outside the level (vq false) on every side, windows half outside,
    exact integers and exact halves."""
    f1, f2, coords, _ = _setup(B, h, w, C, seed)
    coords[:, 0, 1] = (3.0, -9.5)
    coords[:, 0, 2] = (-3.5, 2.0)            # x0 = -(r+1): last valid start
    coords[:, 0, 3] = (-4.0001, 2.0)         # just outside
    coords[:, 0, 4] = (w + 2.0, h + 2.0)     # x0 = wl-1+r: last valid
    coords[:, 0, 5] = (w + 3.0, 1.0)         # outside on the right
    coords[:, 2, 2:6] = np.array([[3.0, 4.0], [0.0, 0.0], [w - 1.0, h - 1.0],
                                  [5.5, 2.5]], np.float32)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                  impl="patch")
    return f1, f2, coords, jp


def test_patch_pyramid_matches():
    """f1/4 and the pooled f2/4, each rounded to bf16 after its own pool:
    the same f32 arithmetic on both sides, so bit-equal; the port stores
    the levels zero-padded by 2r+1."""
    f1, f2, _, jp = _patch_setup(0)
    tp = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                  4, 3, impl="patch")
    assert tp["f1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["f1"].float().numpy().reshape(f1.shape),
        np.asarray(jp["f1"]).astype(np.float32))
    assert len(tp["levels"]) == 4
    for tl, jl in zip(tp["levels"], jp["levels"]):
        jl = np.asarray(jl).astype(np.float32)
        tl = tl.float().numpy()
        np.testing.assert_array_equal(tl[:, 7:-7, 7:-7], jl)
        assert tl.shape[1:3] == (jl.shape[1] + 14, jl.shape[2] + 14)
        assert not tl[:, :7].any() and not tl[:, :, -7:].any()
    with pytest.raises(ValueError):
        tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                 4, 3, impl="slab")


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_patch_lookup_level_matches(level):
    """Kernel 6's plain version against _lookup_level per level.  Each dot
    is an f32 sum of C exact bf16 x bf16 products taken in another order
    than XLA's: a few ulps of the sum of |products|, then a convex
    bilinear mix; atol 4 * C * 2^-24 * max|f1| * max|f2| with C = 32."""
    f1, f2, coords, jp = _patch_setup(10 + level)
    jc = jnp.asarray(coords) / (2 ** level)
    ref = np.asarray(jcorr._lookup_level(jp["f1"], jp["levels"][level], jc, 3))
    tp = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                  4, 3, impl="patch")
    got = tcorr.corr_patch_lookup_level(
        tp["f1"], tp["levels"][level], torch.from_numpy(coords), 3,
        1.0 / 2 ** level).numpy()
    assert got.shape == ref.shape == coords.shape[:3] + (49,)
    atol = 4 * 32 * 2.0 ** -24 * float(
        np.abs(f1 / 4).max() * np.abs(f2 / 4).max())
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    if level == 0:
        # masked queries are exactly zero, valid border queries are not
        assert not got[:, 0, 0].any() and not got[:, 0, 3].any()
        assert not got[:, 0, 5].any() and not got[:, 0, 1].any()
        assert got[:, 0, 2].any() and got[:, 0, 4].any()


def test_corr_lookup_dispatches_on_patch_layout():
    f1, f2, coords, jp = _patch_setup(20, B=1, h=6, w=20)
    ref = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(coords), 3))
    tp = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                  4, 3, impl="patch")
    before = dict(kernels.counts())
    got = tcorr.corr_lookup(tp, torch.from_numpy(coords), 3).numpy()
    assert kernels.counts() == before          # CPU: plain version
    assert got.shape == ref.shape == (1, 6, 20, 196)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # the volume layout on the same features differs by the volume's one
    # extra bf16 rounding only
    vol = tcorr.corr_lookup(tcorr.build_corr_pyramid(
        torch.from_numpy(f1), torch.from_numpy(f2), 4, 3),
        torch.from_numpy(coords), 3).numpy()
    np.testing.assert_allclose(got, vol, atol=2.0 ** -8 * np.abs(got).max(),
                               rtol=0)
