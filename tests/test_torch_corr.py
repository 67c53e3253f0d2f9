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

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


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


def _plan_brute(coords, shapes, radius, box_bytes, tile=(4, 8),
                backward=False, coords_grad=False):
    """Kernel 6's staging rule, tile by tile in numpy; with ``backward``
    its backward's: the box's pixels at 320 bytes each (a bf16 half pixel
    and an f32 row of D) within the budget, in whole 16-pixel m-tiles and
    at least one; with ``coords_grad`` the coordinates' gradient's: the
    box's pixels at 256 bytes each, in whole 8-pixel n-tiles, at least
    one."""
    B, h, w, _ = coords.shape
    t, P = 2 * radius + 2, 2 * radius + 1
    th, tw = tile
    ny, nx = -(-h // th), -(-w // tw)
    out = np.zeros((len(shapes), B, ny, nx), bool)
    for lvl, (Hp, Wp) in enumerate(shapes):
        hl, wl = Hp - 2 * P, Wp - 2 * P
        c = coords * np.float32(1.0 / 2 ** lvl)
        for b in range(B):
            for ty in range(ny):
                for tx in range(nx):
                    sxs, sys_ = [], []
                    for y in range(ty * th, min(h, ty * th + th)):
                        for x in range(tx * tw, min(w, tx * tw + tw)):
                            x0, y0 = np.floor(c[b, y, x])
                            if (-(radius + 1) <= x0 <= wl - 1 + radius
                                    and -(radius + 1) <= y0 <= hl - 1 + radius):
                                sxs.append(int(x0) - radius + P)
                                sys_.append(int(y0) - radius + P)
                    if not sxs:
                        out[lvl, b, ty, tx] = True
                        continue
                    bw = max(sxs) - min(sxs) + t
                    bh = max(sys_) - min(sys_) + t
                    if backward:
                        pixels = max(16, box_bytes // 320 // 16 * 16)
                        out[lvl, b, ty, tx] = bw * bh <= pixels
                    elif coords_grad:
                        pixels = max(8, box_bytes // 256 // 8 * 8)
                        out[lvl, b, ty, tx] = bw * bh <= pixels
                    else:
                        out[lvl, b, ty, tx] = ((bw * 256 + 16) * bh
                                               <= box_bytes)
    return out


@pytest.mark.parametrize("radius", [1, 3])
@pytest.mark.parametrize("box_bytes", [0, 40 * 1024, 96 * 1024])
def test_patch_lookup_plan(radius, box_bytes):
    """The plain planner of kernel 6 says, block by block, which blocks
    stage their window box: against the rule written out tile by tile, on
    a field that is coherent in one batch element and scattered in the
    other, with windows wholly outside the level and ragged edge tiles."""
    rng = np.random.RandomState(7)
    B, h, w = 2, 10, 21
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = np.stack([grid + 0.3 * rng.randn(h, w, 2) + 1.5,
                       grid + 6 * rng.randn(h, w, 2)]).astype(np.float32)
    coords[0, :4, :8] = (-40.0, 3.0)            # a whole tile outside
    coords[1, 9, 20] = (w + 30.0, h + 30.0)
    shapes = [(h + 2 * (2 * radius + 1), w + 2 * (2 * radius + 1)),
              (h // 2 + 2 * (2 * radius + 1), w // 2 + 2 * (2 * radius + 1))]
    got = tcorr.patch_lookup_plan(torch.from_numpy(coords), shapes, radius,
                                  box_bytes=box_bytes)
    ref = _plan_brute(coords, shapes, radius, box_bytes)
    assert got.dtype == torch.bool and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0, 0, 0, 0]          # reads nothing: counts as staged
    if box_bytes == 96 * 1024:      # both paths in one launch
        assert got[0, 0].all() and not got[0, 1].all()
    if box_bytes == 0:
        assert not got[0, 0, 1:].any()


@pytest.mark.parametrize("box_bytes", [0, 100 * 320, None])
@pytest.mark.parametrize("field", ["smooth", "scattered"])
def test_patch_backward_plan(field, box_bytes):
    """The backward's rule in the plain planner (``backward=True``): a
    block's box is one chunk when its bw * bh pixels, 320 bytes each, fit
    the budget (the default ``PATCH_BWD_BOX_BYTES``), else several;
    against each tile's box counted in numpy, on a smooth field (the
    grid moved by a slowly varying +-8 px, as the model's targets are)
    and a scattered one (plus N(0, 6^2) px), ragged tiles, B = 2."""
    rng = np.random.RandomState(9)
    B, h, w = 2, 22, 45
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    if field == "smooth":
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        drift = np.stack([8 * np.sin(xs / 13.0 + ys / 17.0),
                          6 * np.cos(xs / 19.0 - ys / 11.0)], -1)
        coords = grid + drift + 0.25 * rng.randn(B, h, w, 2)
    else:
        coords = grid + 6 * rng.randn(B, h, w, 2)
    coords = coords.astype(np.float32)
    shapes = [(-(-h // 2 ** i) + 14, -(-w // 2 ** i) + 14) for i in range(4)]
    got = tcorr.patch_lookup_plan(torch.from_numpy(coords), shapes, 3,
                                  box_bytes=box_bytes, backward=True)
    budget = tcorr.PATCH_BWD_BOX_BYTES if box_bytes is None else box_bytes
    ref = _plan_brute(coords, shapes, 3, budget, backward=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    share = got[0].float().mean()
    if box_bytes is None:   # the default budget: one chunk where coherent
        assert share > 0.9 if field == "smooth" else share < 0.1
    if box_bytes == 0:      # one m-tile: no box of 8 x 8 taps or more
        assert share < 0.1  # (a block whose windows all miss counts)


@pytest.mark.parametrize("box_bytes", [0, 100 * 256, None])
@pytest.mark.parametrize("field", ["smooth", "scattered"])
def test_patch_coords_plan(field, box_bytes):
    """The coordinates' gradient's rule in the plain planner
    (``coords_grad=True``): a block's box is one chunk when its bw * bh
    pixels, 256 bytes each, fit the budget (the default
    ``PATCH_COORDS_BOX_BYTES``) in whole n-tiles of 8 pixels, else
    several; against each tile's box counted in numpy, on the smooth and
    the scattered field of ``test_patch_backward_plan``."""
    rng = np.random.RandomState(9)
    B, h, w = 2, 22, 45
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    if field == "smooth":
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        drift = np.stack([8 * np.sin(xs / 13.0 + ys / 17.0),
                          6 * np.cos(xs / 19.0 - ys / 11.0)], -1)
        coords = grid + drift + 0.25 * rng.randn(B, h, w, 2)
    else:
        coords = grid + 6 * rng.randn(B, h, w, 2)
    coords = coords.astype(np.float32)
    shapes = [(-(-h // 2 ** i) + 14, -(-w // 2 ** i) + 14) for i in range(4)]
    got = tcorr.patch_lookup_plan(torch.from_numpy(coords), shapes, 3,
                                  box_bytes=box_bytes, coords_grad=True)
    budget = tcorr.PATCH_COORDS_BOX_BYTES if box_bytes is None else box_bytes
    ref = _plan_brute(coords, shapes, 3, budget, coords_grad=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    if box_bytes == 0:      # one n-tile: no box of 8 x 8 taps or more
        assert got[0].float().mean() < 0.1


@pytest.mark.parametrize("layout", ["volume", "patch"])
def test_four_level_lookup_at_batch_two(layout):
    """``corr_lookup`` on a B = 2 pyramid, four levels in one call, against
    codd_tpu's ``corr_lookup`` (tolerances as in the tests above), and
    ``corr_*_levels`` writing into an offset slice of a wider output equal
    to the per-level functions."""
    if layout == "volume":
        f1, f2, coords, jp = _setup(B=2, h=6, w=20, seed=30)
        ref = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(coords), 3,
                                           select="reduce"))
        pyr = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                       torch.from_numpy(f2), 4, 3)
        atol = 2.0 ** -8 * max(float(np.abs(np.asarray(v, np.float32)).max())
                               for v in jp["vols"])
    else:
        f1, f2, coords, jp = _patch_setup(31, B=2, h=6, w=20)
        ref = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(coords), 3))
        pyr = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                       torch.from_numpy(f2), 4, 3,
                                       impl="patch")
        atol = 1e-5
    c = torch.from_numpy(coords)
    got = tcorr.corr_lookup(pyr, c, 3)
    assert tuple(got.shape) == ref.shape == (2, 6, 20, 196)
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)
    wide = torch.full((2, 6, 20, 200), -1.0)
    per = torch.full((2, 6, 20, 200), -1.0)
    for i in range(4):
        if layout == "volume":
            tcorr.corr_lookup_level(pyr[i], c, 3, 1.0 / 2 ** i, out=per,
                                    offset=3 + 49 * i)
        else:
            tcorr.corr_patch_lookup_level(pyr["f1"], pyr["levels"][i], c, 3,
                                          1.0 / 2 ** i, out=per,
                                          offset=3 + 49 * i)
    if layout == "volume":
        tcorr.corr_lookup_levels(pyr, c, 3, out=wide, offset=3)
    else:
        tcorr.corr_patch_lookup_levels(pyr["f1"], pyr["levels"], c, 3,
                                       out=wide, offset=3)
    assert torch.equal(wide, per) and torch.equal(wide[..., 3:199], got)
    assert (wide[..., :3] == -1).all() and (wide[..., 199:] == -1).all()
