"""Kernel 4, the splat compositor: the port's ``splat_render`` (sort +
plain compositor on the CPU) against codd_tpu's inference splat
(``impl="xla_gather"``, ``_splat_one_gather``), its Pallas tile
compositor in interpret mode, and a per-pixel python compositor.  The
CUDA kernel is held against the plain version in test_torch_gpu.py.

Inputs keep every depth distinct after the packed-key quantization, so
the fragment order is defined (codd_tpu's unstable sort orders equal keys
arbitrarily); the Pallas comparison keeps every 1024-pixel tile under its
WMAX fragments, so nothing is dropped.  Tolerances: codd_tpu sums each
pixel's composite as the difference of two rows of a global f32 cumsum
over all fragments, so its error grows with the running sum; at these
sizes that is below 2e-4 for features and 1e-3 for depth."""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from codd_tpu.ops.splat import splat_render as jsplat
from codd_torch.ops import kernels
from codd_torch.ops import splat as tsplat

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


def _scene(H, W, C, N, seed, radius):
    rng = np.random.RandomState(seed)
    fx = fy = 15.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    # depths 2% apart: distinct in the packed keys of both the gather path
    # (>= 17 z bits here) and the Pallas path (21), whose 8+ mantissa bits
    # resolve 0.4%
    Z = (1.02 ** rng.permutation(N)).astype(np.float32)
    px = rng.uniform(-radius, W + radius, N).astype(np.float32)
    py = rng.uniform(-radius, H + radius, N).astype(np.float32)
    pts = np.stack([(px - cx) / fx * Z, (py - cy) / fy * Z, Z], -1)[None]
    pts[0, :3, 2] = -1.0   # behind the camera: culled
    feats = rng.randn(1, N, C).astype(np.float32)
    intr = np.array([[fx, fy, cx, cy]], np.float32)
    return pts.astype(np.float32), feats, intr


def _brute(pts, feats, intr, H, W, radius, ppp=8):
    fx, fy, cx, cy = intr[0]
    X, Y, Z = pts[0].T
    out = np.zeros((H, W, feats.shape[-1]), np.float64)
    zb = np.zeros((H, W), np.float64)
    for yy in range(H):
        for xx in range(W):
            frags = []
            for n in range(len(Z)):
                if Z[n] <= 1e-4:
                    continue
                x = fx * (X[n] / Z[n]) + cx
                y = fy * (Y[n] / Z[n]) + cy
                a = 1.0 - ((xx - x) ** 2 + (yy - y) ** 2) / radius ** 2
                if a > 0:
                    frags.append((Z[n], min(a, 1 - 1e-4), feats[0, n]))
            frags.sort(key=lambda f: f[0])
            t = 1.0
            for z, a, f in frags[:ppp]:
                out[yy, xx] += t * a * f
                t *= 1 - a
            zb[yy, xx] = frags[0][0] if frags else 0.0
    return out, zb


@pytest.mark.parametrize("H,W,C,N,radius", [
    (10, 12, 6, 80, 1.0),    # the full-res call: C=6, r=1
    (12, 16, 32, 70, 2.0),   # the quarter-res call: C=32, r=2
])
def test_splat_matches_gather_pallas_and_bruteforce(H, W, C, N, radius):
    pts, feats, intr = _scene(H, W, C, N, seed=C, radius=radius)
    args = (jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(intr))
    jo, jz = jsplat(*args, H=H, W=W, radius_px=radius, impl="xla_gather")
    po, pz = jsplat(*args, H=H, W=W, radius_px=radius, impl="pallas")
    before = kernels.counts()["splat_composite"]
    to, tz = tsplat.splat_render(torch.from_numpy(pts),
                                 torch.from_numpy(feats),
                                 torch.from_numpy(intr), H, W, radius)
    assert kernels.counts()["splat_composite"] == before
    bo, bz = _brute(pts, feats, intr, H, W, radius)
    assert (bz > 0).mean() > 0.5   # most pixels are covered
    for o, z in ((jo, jz), (po, pz)):
        np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=2e-4)
        np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-3)
    np.testing.assert_allclose(to[0].numpy(), bo, atol=1e-5)
    np.testing.assert_allclose(tz[0].numpy(), bz, atol=1e-6)


def _clustered_scene(H, W, C, N, n_cluster, seed):
    """``n_cluster`` of the N points within a pixel of one spot, the rest
    spread over the frame: a few pixels hold thousands of fragments.
    Depths 2 + 0.001 i stay distinct in the 25-bit z key of a 10x12 frame
    and small enough for codd_tpu's cumsum."""
    rng = np.random.RandomState(seed)
    fx = fy = 15.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    Z = (2.0 + 0.001 * rng.permutation(N)).astype(np.float32)
    px = rng.uniform(-2, W + 2, N).astype(np.float32)
    py = rng.uniform(-2, H + 2, N).astype(np.float32)
    px[:n_cluster] = rng.uniform(3.0, 4.0, n_cluster)
    py[:n_cluster] = rng.uniform(4.0, 5.0, n_cluster)
    pts = np.stack([(px - cx) / fx * Z, (py - cy) / fy * Z, Z], -1)[None]
    feats = rng.randn(1, N, C).astype(np.float32)
    intr = np.array([[fx, fy, cx, cy]], np.float32)
    return pts.astype(np.float32), feats, intr


def test_clustered_scene_long_runs_wide_features():
    """Runs of thousands of fragments, far past points_per_pixel, and C=40,
    past the 32 channels one pass of the card kernel's lane group holds:
    the port's splat_render and composite_plain on the CPU against the
    brute-force compositor and codd_tpu's gather path.  The card kernel is
    held against composite_plain on the same kind of scene in
    test_torch_gpu.py."""
    H, W, C, N, radius = 10, 12, 40, 2600, 2.0
    pts, feats, intr = _clustered_scene(H, W, C, N, 2300, seed=3)
    args = (torch.from_numpy(pts), torch.from_numpy(feats),
            torch.from_numpy(intr))
    order, offsets, alpha, Z = tsplat.sort_fragments(args[0][0], args[2][0],
                                                     H, W, radius)
    runs = offsets[1:] - offsets[:-1]
    assert int(runs.max()) > 2048 and int((runs > 8).sum()) > 4
    out, zbuf, cnt = tsplat.composite_plain(order, offsets, alpha, Z,
                                            args[1][0])
    assert torch.equal(cnt, runs.float())
    to, tz = tsplat.splat_render(*args, H, W, radius)
    assert torch.equal(to[0].reshape(-1, C), out)
    assert torch.equal(tz[0].reshape(-1), zbuf)
    jo, jz = jsplat(*(jnp.asarray(a) for a in (pts, feats, intr)), H=H, W=W,
                    radius_px=radius, impl="xla_gather")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-3)
    bo, bz = _brute(pts, feats, intr, H, W, radius)
    np.testing.assert_allclose(to[0].numpy(), bo, atol=1e-5)
    np.testing.assert_allclose(tz[0].numpy(), bz, atol=1e-6)


def test_ties_break_on_fragment_index():
    """Equal packed keys keep fragment-index order (stable sort): of two
    points at the same depth on one pixel, the lower point id is in front."""
    pts = np.array([[[0.0, 0.0, 2.0], [0.0, 0.0, 2.0]]], np.float32)
    feats = np.array([[[1.0], [100.0]]], np.float32)
    intr = np.array([[10.0, 10.0, 2.0, 2.0]], np.float32)
    out, zbuf = tsplat.splat_render(*(torch.from_numpy(a) for a in
                                      (pts, feats, intr)), 5, 5, 1.0)
    a = 1 - 1e-4
    assert abs(float(out[0, 2, 2, 0]) - (a + (1 - a) * a * 100)) < 1e-4
    assert float(zbuf[0, 2, 2]) == 2.0


def test_quantize_z_matches_reference_bits():
    z = np.float32([1e-3, 0.5, 1.0, 3.14159, 210.0, 1e6])
    for z_bits in (13, 17):
        got = tsplat._quantize_z(torch.from_numpy(z), z_bits).numpy()
        ref = z.view(np.uint32) >> (32 - z_bits)
        np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert 32 - (384 * 1280 + 1).bit_length() == 13
    assert 32 - (96 * 320 + 1).bit_length() == 17


def test_composite_cap_and_empty_pixels():
    """points_per_pixel caps the composite but not the count; empty
    pixels give zero features, depth and count."""
    n = 12
    pts = np.zeros((1, n, 3), np.float32)
    pts[0, :, 2] = 1.0 + np.arange(n) * 0.5
    feats = np.ones((1, n, 2), np.float32)
    intr = np.array([[10.0, 10.0, 1.0, 1.0]], np.float32)
    order, offsets, alpha, Z = tsplat.sort_fragments(
        torch.from_numpy(pts[0]), torch.from_numpy(intr[0]), 3, 3, 1.0)
    out, zbuf, cnt = tsplat.composite_plain(order, offsets, alpha, Z,
                                            torch.from_numpy(feats[0]), 8)
    c = 4  # pixel (1, 1) holds every point
    assert cnt[c] == n and zbuf[c] == 1.0
    a = 1 - 1e-4
    expect = sum(a * (1 - a) ** i for i in range(8))
    assert math.isclose(float(out[c, 0]), expect, rel_tol=1e-5)
    mask = torch.ones(9, dtype=torch.bool)
    mask[c] = False
    assert (cnt[mask] == 0).all() and (zbuf[mask] == 0).all()
    assert (out[mask] == 0).all()
