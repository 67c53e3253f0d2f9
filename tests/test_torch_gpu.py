"""The six CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and a small streaming run whose launch
counts show that every step went through them; the backward of kernels 1
(f32 and bf16), 4, 5 and 6, the forward-only kernels' raises under autograd, a training
step of the stereo, the fusion, the motion and the joint stage, and one
step of the training entry from PNG frames (the native decoder beside).
Marked ``gpu``; each test skips itself when there is no CUDA card
(chip_smoke.py runs the same checks at the full 384x1280 shapes).  Torch only, so that it also runs
where JAX is not installed:
``python -m pytest tests/test_torch_gpu.py --noconftest -m gpu``."""

import contextlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from codd_torch.models.codd import CODD
from codd_torch.ops import corr, gn, kernels, se3, splat, tile_warp
from codd_torch.ops.projective import inv_project

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _g():
    return torch.Generator().manual_seed(0)


def _launched(name, fn):
    before = kernels.counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.counts()[name] == before + 1
    return out


def test_tile_warp_kernel(dev):
    g = _g()
    fl, fr = (torch.randn(2, 32, 128, 24, generator=g).to(dev)
              for _ in range(2))
    hyp3 = torch.stack([torch.rand(2, 8, 32, generator=g) * 100,
                        torch.rand(2, 8, 32, generator=g) * 2 - 1,
                        torch.rand(2, 8, 32, generator=g) * 2 - 1], -1).to(dev)
    got = _launched("tile_warp_cost",
                    lambda: tile_warp.tile_warp_cost(hyp3, fl, fr))
    ref = tile_warp.tile_warp_cost_plain(hyp3, fl, fr)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def _bf16_ulps(got, ref):
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    return ((got.float() - ref).abs() / ulp)


@pytest.mark.parametrize("form", ["exact", "pallas"])
def test_tile_warp_kernel_bf16_forms(dev, form):
    """Kernel 1's bf16 forms on the full-res strip (W=1280: the exact
    form's bf16 x grid rounds above 512 and 1024; taps past both edges)
    against their plain versions on the card: within 1 bf16 ulp (the
    kernel sums a pixel's channels in order, PyTorch in its own order,
    both in f32 before the one rounding), almost all equal; the share off
    the plain version's bits is printed (``-s``)."""
    g = _g()
    B, H, W, C = 2, 8, 1280, 16
    fl, fr = (torch.randn(B, H, W, C, generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    d = torch.rand(B, H // 4, W // 4, generator=g) * 1224 - 200
    hyp3 = torch.stack([d, torch.rand(B, H // 4, W // 4, generator=g) * 2.4
                        - 1.2, torch.rand(B, H // 4, W // 4, generator=g)
                        * 2.4 - 1.2], -1).to(dev, torch.bfloat16)
    got = _launched("tile_warp_cost",
                    lambda: tile_warp.tile_warp_cost(hyp3, fl, fr, form))
    ref = tile_warp.tile_warp_cost_plain(hyp3, fl, fr, form)
    assert got.dtype == ref.dtype == torch.bfloat16
    u = _bf16_ulps(got, ref)
    print(f"tile_warp_cost bf16 {form}: {u.max().item():.2f} ulps, unequal "
          f"share {(u > 0).float().mean().item():.2e}")
    assert u.max().item() <= 1.0 and (u > 0).float().mean().item() < 1e-2
    with pytest.raises(TypeError):
        tile_warp.tile_warp_cost(hyp3.float(), fl, fr, form)


def _corr_coords(dev, r, B=2, h=12, w=40):
    """Batch element 0 coherent (the grid plus 0.3 px), element 1 scattered
    (plus N(0, 8^2) px); in both, windows wholly outside the level, partly
    outside (the first and last valid starts) and at the padded edge."""
    g = _g()
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([xs, ys], -1).float()
    c = torch.stack([grid + torch.randn(h, w, 2, generator=g) * 0.3,
                     grid + torch.randn(h, w, 2, generator=g) * 8.0])[:B]
    c[:, 0, 0] = torch.tensor([-30.0, 2.0])                 # wholly outside
    c[:, 0, 1] = torch.tensor([-(r + 0.5), 2.0])            # first valid
    c[:, 0, 2] = torch.tensor([-(r + 1.5), 2.0])            # just outside
    c[:, 5, 3] = torch.tensor([w - 1 + r + 0.5, h - 1 + r + 0.5])  # edge
    c[:, 5, 4] = torch.tensor([w + r + 0.5, 1.0])           # right, outside
    c[:, 6, 6] = torch.tensor([3.0, 4.0])                   # exact integers
    return c.to(dev).contiguous()


def _four_levels(pyr, coords, r, per_level):
    """corr_lookup's one launch, and one launch a level into the same
    channels: equal bits."""
    got = corr.corr_lookup(pyr, coords, r)
    per = torch.full_like(got, float("nan"))
    for i in range(4):
        per_level(i, per)
    torch.cuda.synchronize()
    assert torch.equal(got, per)
    return got


@pytest.mark.parametrize("r", [0, 1, 3])
def test_corr_lookup_kernel(dev, r):
    g = _g()
    f1, f2 = (torch.randn(2, 12, 40, 64, generator=g).to(dev)
              for _ in range(2))
    vols = corr.build_corr_pyramid(f1, f2, 4, r)
    coords = _corr_coords(dev, r)
    K = (2 * r + 1) ** 2
    kernels.reset_counts()
    got = _four_levels(vols, coords, r, lambda i, out: corr.corr_lookup_level(
        vols[i], coords, r, 1.0 / 2 ** i, out=out, offset=i * K))
    assert kernels.counts()["corr_lookup"] == 1 + 4
    ref = torch.cat([corr.corr_lookup_level_plain(v, coords / 2 ** i, r)
                     for i, v in enumerate(vols)], -1)
    # the same bf16 taps and the same bilinear arithmetic order
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    # level 0: masked outside, not at the first valid start
    assert not got[:, 0, 0, :K].any() and got[:, 0, 1, :K].any()
    with pytest.raises(ValueError):
        corr.corr_lookup_level(vols[0][:, :-1].contiguous(), coords, r)


@pytest.mark.parametrize("r", [0, 1, 3])
def test_corr_patch_kernel(dev, r, monkeypatch):
    """Both of kernel 6's paths in one launch (the plain planner shows
    that the inputs reach both), against the plain version, four levels
    equal to one launch a level, and every block through global memory
    (box budget 0) equal in bits to the staged run."""
    g = _g()
    f1, f2 = (torch.randn(2, 12, 40, 128, generator=g).to(dev)
              for _ in range(2))
    pyr = corr.build_corr_pyramid(f1, f2, 4, r, impl="patch")
    coords = _corr_coords(dev, r)
    K = (2 * r + 1) ** 2
    plan = corr.patch_lookup_plan(
        coords, [tuple(l.shape[1:3]) for l in pyr["levels"]], r)
    assert plan[0].any() and not plan[0].all()
    got = _four_levels(pyr, coords, r,
                       lambda i, out: corr.corr_patch_lookup_level(
                           pyr["f1"], pyr["levels"][i], coords, r,
                           1.0 / 2 ** i, out=out, offset=i * K))
    ref = torch.cat([corr.corr_patch_lookup_level_plain(
        pyr["f1"], l, coords / 2 ** i, r) for i, l in enumerate(pyr["levels"])],
        -1)
    # f32 sums of 128 exact products in another order
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)
    # level 0: masked outside, not at the first valid start
    assert not got[:, 0, 0, :K].any() and got[:, 0, 1, :K].any()
    monkeypatch.setattr(corr, "PATCH_BOX_BYTES", 0)
    direct = corr.corr_lookup(pyr, coords, r)
    torch.cuda.synchronize()
    assert torch.equal(direct, got)
    monkeypatch.undo()
    kernels.reset_counts()
    out = corr.corr_lookup(pyr, coords, r)
    torch.cuda.synchronize()
    assert kernels.counts()["corr_patch_lookup"] == 1
    assert kernels.counts()["corr_lookup"] == 0 and out.shape[-1] == 4 * K
    bad = {"f1": pyr["f1"][..., :64].contiguous(),
           "levels": [l[..., :64].contiguous() for l in pyr["levels"]]}
    with pytest.raises(ValueError):
        corr.corr_lookup(bad, coords, r)
    # coordinates that require grad: the same forward, under autograd
    level0 = corr.corr_patch_lookup_level(pyr["f1"], pyr["levels"][0],
                                          coords.clone().requires_grad_(), r)
    assert level0.requires_grad and torch.equal(level0.detach(),
                                                got[..., :K])


def _gn_inputs(dev, h=12, w=72, B=1, scale=1 / 8):
    # the default shape has a partial tile at the right
    g = _g()
    depth = (torch.rand(B, h, w, generator=g) * 30 + 2).to(dev)
    intr = torch.tensor([[60.0, 60.0, w / 2, h / 2]] * B, device=dev)
    Ts = se3.exp((torch.randn(B, h, w, 6, generator=g) * 0.01).to(dev))
    target = torch.randn(B, h, w, 3, generator=g).to(dev)
    weight = torch.rand(B, h, w, 3, generator=g).to(dev)
    vals = gn.build_vals(Ts, target, weight, depth, intr).contiguous()
    ae = (torch.randn(B, h, w, 32, generator=g) * scale).to(dev)
    return ae, vals


def test_gn_fused_kernel(dev):
    ae, vals = _gn_inputs(dev)
    got = _launched("gn_fused_solve", lambda: gn.gn_fused_solve(ae, vals))
    ref = gn.gn_fused_solve_plain(ae, vals)
    torch.testing.assert_close(got, ref, atol=1e-5,
                               rtol=1e-3)


@pytest.mark.parametrize("bf16", [False, True])
def test_gn_window_kernel(dev, bf16):
    ae, vals = _gn_inputs(dev)
    got = _launched("gn_window_aggregate",
                    lambda: gn.gn_window_aggregate(ae, vals, 32, bf16))
    ref = gn.gn_window_aggregate_plain(ae, vals, 32, bf16)
    # ~800-term f32 sums in another order, relative to the largest sum;
    # with bf16 scores a score on a rounding boundary may move by 2^-8 of
    # its term
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, atol=(1e-3 if bf16 else 1e-5) * scale,
                               rtol=1e-4)
    # kernel 3 solves on the same sums
    fused = _launched("gn_fused_solve",
                      lambda: gn.gn_fused_solve(ae, vals, bf16_scores=bf16))
    torch.testing.assert_close(fused, gn.damped_solve(got), atol=1e-5,
                               rtol=1e-3)


@pytest.mark.parametrize("scale", [1 / 8, 1.0])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("h,w,radius,B", [(5, 19, 3, 2), (9, 40, 32, 1),
                                          (12, 72, 32, 1), (48, 160, 32, 1)])
def test_gn_kernels_at_every_shape(dev, h, w, radius, B, scale, bf16):
    """A ragged last tile, w < R, h < R, R = 3, B = 2 and the main path's
    48x160, at the model's embedding scale and at 1.0 (|q|^2 ~ 32, where
    the norms' cancellation bites).  Each of the 27 sums is held to 1e-5
    (bf16 scores: 2^-12) of its own sum of |terms|, plus what f32 rounding
    of the logit's three terms allows (8 ulp of 2 max|q|^2: 5e-7 at the
    model's scale; see tests/test_torch_gn.py); kernel 3 solves on the
    same sums; two launches on one input give the same bits."""
    ae, vals = _gn_inputs(dev, h, w, B, scale)
    got = _launched("gn_window_aggregate",
                    lambda: gn.gn_window_aggregate(ae, vals, radius, bf16))
    ref = gn.gn_window_aggregate_plain(ae, vals, radius, bf16)
    absum = gn.gn_window_aggregate_plain(ae, vals.abs(), radius)
    noise = 8 * 2.0 ** -24 * 2 * float((ae * ae).sum(-1).max())
    tol = ((2.0 ** -12 if bf16 else 1e-5) + noise) * absum + 1e-6
    assert got.shape == (B, h, w, 27) and torch.isfinite(got).all()
    assert ((got - ref).abs() <= tol).all()
    fused = _launched("gn_fused_solve", lambda: gn.gn_fused_solve(
        ae, vals, radius, bf16_scores=bf16))
    assert fused.shape == (B, h, w, 6)
    torch.testing.assert_close(fused, gn.damped_solve(got), atol=1e-5,
                               rtol=1e-3)
    assert torch.equal(got, gn.gn_window_aggregate(ae, vals, radius, bf16))
    assert torch.equal(fused, gn.gn_fused_solve(ae, vals, radius,
                                                bf16_scores=bf16))


def test_gn_step_routes(dev):
    """windowed / pallas_window launch kernel 5, auto / fused kernel 3,
    dense neither; all agree."""
    g = _g()
    h, w = 8, 128
    depth = (torch.rand(1, h, w, generator=g) * 30 + 2).to(dev)
    intr = torch.tensor([[60.0, 60.0, w / 2, h / 2]], device=dev)
    Ts = se3.exp((torch.randn(1, h, w, 6, generator=g) * 0.01).to(dev))
    target = torch.randn(1, h, w, 3, generator=g).to(dev)
    weight = torch.rand(1, h, w, 3, generator=g).to(dev)
    ae = torch.randn(1, h, w, 32, generator=g).to(dev)
    outs = {}
    for impl, name in (("auto", "gn_fused_solve"), ("fused", "gn_fused_solve"),
                       ("windowed", "gn_window_aggregate"),
                       ("pallas_window", "gn_window_aggregate"),
                       ("dense", None)):
        kernels.reset_counts()
        outs[impl] = gn.gn_step(Ts, ae, target, weight, depth, intr, impl=impl)
        torch.cuda.synchronize()
        want = {k: int(k == name) for k in kernels.KERNELS}
        assert kernels.counts() == want, impl
    for impl in outs:
        torch.testing.assert_close(outs[impl], outs["dense"], atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_gn_step_routes_at_every_width(dev, bf16):
    """12x72 (w not a multiple of 32, where codd_tpu runs its dense form):
    the kernels still launch, with f32 scores, and agree with dense."""
    g = _g()
    h, w = 12, 72
    depth = (torch.rand(1, h, w, generator=g) * 30 + 2).to(dev)
    intr = torch.tensor([[60.0, 60.0, w / 2, h / 2]], device=dev)
    Ts = se3.exp((torch.randn(1, h, w, 6, generator=g) * 0.01).to(dev))
    target = torch.randn(1, h, w, 3, generator=g).to(dev)
    weight = torch.rand(1, h, w, 3, generator=g).to(dev)
    ae = torch.randn(1, h, w, 32, generator=g).to(dev)
    assert gn.resolve_impl("windowed", 32, w) == "dense"
    dense = gn.gn_step(Ts, ae, target, weight, depth, intr, impl="dense")
    for impl, name in (("auto", "gn_fused_solve"), ("fused", "gn_fused_solve"),
                       ("windowed", "gn_window_aggregate"),
                       ("pallas_window", "gn_window_aggregate")):
        kernels.reset_counts()
        out = gn.gn_step(Ts, ae, target, weight, depth, intr, impl=impl,
                         bf16_scores=bf16)
        torch.cuda.synchronize()
        want = {k: int(k == name) for k in kernels.KERNELS}
        assert kernels.counts() == want, impl
        torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-4)


def _splat_points(dev, h, w, cluster):
    """The motion module's points for an (h, w) frame; ``cluster`` moves
    3000 of them within a pixel of (40, 8) and the rest into the top third
    of the frame, so a few pixels hold thousands of fragments and the rows
    below 18 none."""
    g = _g()
    intr = torch.tensor([60.0, 60.0, w / 2, h / 2], device=dev)
    depth = (torch.rand(1, h, w, generator=g) * 30 + 2).to(dev)
    pts = se3.act(se3.exp((torch.randn(1, h, w, 6, generator=g) * 0.01)
                          .to(dev)), inv_project(depth, intr[None]))
    pts = pts.reshape(-1, 3)
    if cluster:
        u = torch.rand(h * w, 2, generator=g).to(dev)
        spot = torch.tensor([40.0, 8.0], device=dev)
        top = torch.tensor([float(w), h / 3], device=dev)
        first = torch.arange(h * w, device=dev)[:, None] < 3000
        uv = torch.where(first, u + spot, u * top)
        Z = pts[:, 2:]
        pts = torch.cat([(uv - intr[2:]) / intr[:2] * Z, Z], -1)
    return pts, intr, g


@pytest.mark.parametrize("C,radius,cluster,ppp", [
    (6, 1.0, False, 8),    # the full-res call
    (32, 2.0, False, 8),   # the quarter-res call
    (1, 2.0, False, 8),
    (40, 2.0, False, 8),   # past the 32 channels the first kernel took
    (6, 1.0, True, 8),
    (40, 2.0, True, 8),
    (40, 2.0, True, 50),   # more fragments composited than a warp has lanes
    (6, 1.0, True, 0)])
def test_splat_composite_kernel(dev, C, radius, cluster, ppp):
    """Kernel 4 against the plain version, two launches equal in bits, and
    every form of it equal in bits to the one it chooses.  A clustered
    scene has runs of more than 2048 fragments, far past points_per_pixel,
    beside empty rows."""
    h, w = 48, 80
    pts, intr, g = _splat_points(dev, h, w, cluster)
    feat = torch.randn(h * w, C, generator=g).to(dev)
    order, offsets, alpha, Z = splat.sort_fragments(pts, intr, h, w, radius)
    runs = offsets[1:] - offsets[:-1]
    if cluster:
        assert int(runs.max()) > 2048 and not runs[18 * w:].any()
    args = (order, offsets, alpha, Z.contiguous(), feat, ppp)
    got = _launched("splat_composite", lambda: splat.composite(*args))
    ref = splat.composite_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    again = splat.composite(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for form in splat.FORMS:
        if form != "walk" or C <= splat.WALK_C:
            other = splat.composite_form(*args[:5], form, ppp)
            assert all(torch.equal(a, b) for a, b in zip(got, other)), form
    with pytest.raises(ValueError) if C > splat.WALK_C else \
            contextlib.nullcontext():
        splat.composite_form(*args[:5], "walk", ppp)


@pytest.mark.parametrize("C,radius,cluster,ppp", [
    (6, 1.0, False, 8),    # the full-res training call (the walk)
    (32, 2.0, False, 8),   # the quarter-res training call (the lanes)
    (40, 2.0, True, 8),    # runs far past points_per_pixel
    (6, 1.0, True, 3),
    (1, 2.0, False, 1),
    (8, 2.0, True, 2),     # the walk's widest C
    (9, 2.0, True, 4),     # the lanes' narrowest, rows not 8-byte aligned
    (32, 2.0, True, 5),
    (1, 1.0, True, 6),
    (9, 1.0, False, 7)])
def test_splat_composite_backward_kernel(dev, C, radius, cluster, ppp):
    """Kernel 4's backward against ``composite_backward_plain`` on random
    cotangents, each element within 1e-5 of its sum of |terms|
    (``composite_backward_terms``: f32 sums of at most C products, K
    fragments or ppp suffix terms against the plain version's f64
    transmittance and suffix sums, a transmittance T counted
    (1 + |log T|) times as the kernel sums log T in f32; dalpha's suffix
    part divides by
    1 - alpha, down to 1e-4, and its two parts may cancel) plus 2^-122
    (the plain version's ``index_add_`` adds by float atomics, which flush
    subnormals to zero on the card: K = 16 of 2^-126); every fragment id
    written (culled ones 0); two launches equal in bits.  Each form of
    each pass (the walk for C <= 8, the lanes above), points_per_pixel 1
    to 8, runs longer than it where the points cluster."""
    h, w = 48, 80
    pts, intr, g = _splat_points(dev, h, w, cluster)
    feat = torch.randn(h * w, C, generator=g).to(dev)
    order, offsets, alpha, Z = splat.sort_fragments(pts, intr, h, w, radius)
    if cluster:
        assert int((offsets[1:] - offsets[:-1]).max()) > ppp
    gout = torch.randn(h * w, C, generator=g).to(dev)
    gz = torch.randn(h * w, generator=g).to(dev)
    args = (order, offsets, alpha, feat, gout, gz, ppp)
    got = _launched("splat_composite_backward",
                    lambda: splat.composite_backward(*args))
    ref = splat.composite_backward_plain(*args)
    terms = splat.composite_backward_terms(*args)
    for a, b, t in zip(got, ref, terms):
        assert torch.isfinite(a).all()
        assert bool(((a - b).abs() <= 1e-5 * t + 2.0 ** -122).all())
    assert not got[1][alpha == 0].any()
    again = splat.composite_backward(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="points_per_pixel"):
        splat.composite_backward(*args[:6], splat.BWD_PPP + 1)


def test_splat_render_under_autograd(dev):
    """``splat_render`` on points and features that need a gradient runs
    kernel 4 and its backward once an image each, and its gradients are
    autograd's through the plain version to 1e-4 of their largest; with
    no gradient needed, the forward alone."""
    h, w, C = 48, 80, 6
    pts, intr, g = _splat_points(dev, h, w, False)
    feat = torch.randn(2, h * w, C, generator=g).to(dev)
    pts = torch.stack([pts, pts * 1.01])
    intr2 = torch.stack([intr, intr])
    gout = torch.randn(2, h, w, C, generator=g).to(dev)
    gz = torch.randn(2, h, w, generator=g).to(dev)
    grads = []
    for kernel in (True, False):
        p, f = pts.clone().requires_grad_(), feat.clone().requires_grad_()
        kernels.reset_counts()
        if kernel:
            out, zb = splat.splat_render(p, f, intr2, h, w, 1.0)
        else:
            outs, zbs = [], []
            for b in range(2):
                order, offsets, alpha, Z = splat.sort_fragments(
                    p[b], intr2[b], h, w, 1.0)
                o, z, _ = splat.composite_plain(order, offsets, alpha, Z,
                                                f[b])
                outs.append(o.reshape(h, w, C))
                zbs.append(z.reshape(h, w))
            out, zb = torch.stack(outs), torch.stack(zbs)
        ((out * gout).sum() + (zb * gz).sum()).backward()
        torch.cuda.synchronize()
        if kernel:
            assert kernels.counts()["splat_composite"] == 2
            assert kernels.counts()["splat_composite_backward"] == 2
        grads.append((p.grad, f.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=1e-4)
    kernels.reset_counts()
    splat.splat_render(pts, feat, intr2, h, w, 1.0)
    torch.cuda.synchronize()
    assert kernels.counts()["splat_composite"] == 2
    assert kernels.counts()["splat_composite_backward"] == 0


def test_streaming_goes_through_the_kernels(dev):
    model = CODD(max_disp=64, iters=2).to(dev).eval()
    g = _g()
    frames = [(torch.rand(1, 64, 128, 3, generator=g).to(dev),
               torch.rand(1, 64, 128, 3, generator=g).to(dev))
              for _ in range(3)]
    intr = torch.tensor([[100.0, 100.0, 64.0, 32.0]], device=dev)
    kernels.reset_counts()
    carry, _ = model.first_step(*frames[0], intr)
    for left, right in frames[1:]:
        carry, out = model.step(carry, left, right, intr)
    torch.cuda.synchronize()
    # 9 tile warps a frame; one corr lookup (four levels) and one GN solve
    # an iteration; 2 splats
    assert kernels.counts() == {"tile_warp_cost": 27, "corr_lookup": 4,
                                "gn_fused_solve": 4, "splat_composite": 4,
                                "gn_window_aggregate": 0,
                                "corr_patch_lookup": 0,
                                "tile_warp_cost_backward": 0,
                                "gn_window_aggregate_backward": 0,
                                "corr_patch_lookup_backward": 0,
                                "splat_composite_backward": 0,
                                "corr_patch_lookup_coords_backward": 0}
    assert torch.isfinite(out["pred_disp"]).all()


def test_bf16_streaming_goes_through_the_kernels(dev):
    """The bf16 model (parameters and frames cast, f32 intrinsics) streams
    through the same kernels as the f32 one, kernel 1 in its bf16 form,
    with codd_tpu's dtypes at the outputs."""
    from codd_torch.utils.precision import cast_floats
    model = cast_floats(CODD(max_disp=64, iters=2).to(dev).eval())
    g = _g()
    frames = [(torch.rand(1, 64, 128, 3, generator=g).to(dev, torch.bfloat16),
               torch.rand(1, 64, 128, 3, generator=g).to(dev, torch.bfloat16))
              for _ in range(3)]
    intr = torch.tensor([[100.0, 100.0, 64.0, 32.0]], device=dev)
    kernels.reset_counts()
    carry, _ = model.first_step(*frames[0], intr)
    for left, right in frames[1:]:
        carry, out = model.step(carry, left, right, intr)
    torch.cuda.synchronize()
    assert kernels.counts() == {"tile_warp_cost": 27, "corr_lookup": 4,
                                "gn_fused_solve": 4, "splat_composite": 4,
                                "gn_window_aggregate": 0,
                                "corr_patch_lookup": 0,
                                "tile_warp_cost_backward": 0,
                                "gn_window_aggregate_backward": 0,
                                "corr_patch_lookup_backward": 0,
                                "splat_composite_backward": 0,
                                "corr_patch_lookup_coords_backward": 0}
    assert carry.memory_disp.dtype == out["pred_disp"].dtype == torch.float32
    assert out["pred_curr"].dtype == out["Ts"].dtype == torch.bfloat16
    assert all(torch.isfinite(v.float()).all() for v in out.values())


def test_eval_path_goes_through_kernels_5_and_6(dev):
    """run_inference with gn_impl="pallas_window", corr_impl="patch" at a
    width where the windowed path applies (w/8 = 128)."""
    import numpy as np
    from codd_torch.apis.inference import run_inference

    model = CODD(max_disp=64, iters=2, gn_impl="pallas_window",
                 corr_impl="patch").to(dev).eval()
    rng = np.random.RandomState(0)
    T, H, W = 3, 64, 1024

    class OneClip:
        def __len__(self):
            return 1

        def __getitem__(self, i):
            return {"imgs": rng.rand(T, H, W, 3).astype(np.float32),
                    "r_imgs": rng.rand(T, H, W, 3).astype(np.float32),
                    "gt_disp": rng.uniform(2, 40, (T, H, W, 1)
                                           ).astype(np.float32),
                    "gt_flow": rng.uniform(-2, 2, (T, H, W, 2)
                                           ).astype(np.float32),
                    "gt_disp_change": np.zeros((T, H, W, 1), np.float32),
                    "meta": {"filename": "clip/0000.png",
                             "img_shape": (H, W), "disp_range": (1.0, 210.0),
                             "intrinsics": [100.0, 100.0, W / 2, H / 2]}}

    kernels.reset_counts()
    metrics = run_inference(model, OneClip(), evaluate=True,
                            log=lambda *_: None)
    assert kernels.counts() == {"tile_warp_cost": 27, "corr_lookup": 0,
                                "gn_fused_solve": 0, "splat_composite": 4,
                                "gn_window_aggregate": 4,
                                "corr_patch_lookup": 4,
                                "tile_warp_cost_backward": 0,
                                "gn_window_aggregate_backward": 0,
                                "corr_patch_lookup_backward": 0,
                                "splat_composite_backward": 0,
                                "corr_patch_lookup_coords_backward": 0}
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["count"] > 0


def _tile_warp_inputs(dev, B, H, W, C, field="random"):
    """Disparities from -20 to W + 20 and slants in [-2, 2]: taps past
    both edges of the image.  ``"smooth"``: one disparity (20.3) and no
    slant, so that neighbouring pixels share their taps; ``"pile"``: every
    pixel's taps on the same 4 columns (x0 = 100), one sort bin."""
    g = _g()
    fl, fr = (torch.randn(B, H, W, C, generator=g).to(dev) for _ in range(2))
    hyp3 = torch.stack([torch.rand(B, H // 4, W // 4, generator=g)
                        * (W + 40) - 20,
                        torch.rand(B, H // 4, W // 4, generator=g) * 4 - 2,
                        torch.rand(B, H // 4, W // 4, generator=g) * 4 - 2],
                       -1).to(dev)
    if field != "random":
        hyp3 = torch.zeros_like(hyp3)
        hyp3[..., 0] = 20.3
    if field == "pile":
        # local_d = d + (j - 1.5) dx with dx = 1: x - local_d = 100.25
        hyp3[..., 0] = (torch.arange(W // 4, device=dev) * 4.0 + 1.5
                        - 100.25)
        hyp3[..., 1] = 1.0
    gout = torch.randn(B, H // 4, W // 4, 48, generator=g).to(dev)
    return hyp3, fl, fr, gout


@pytest.mark.parametrize("B,H,W,C,field", [
    (2, 16, 64, 16, "random"), (1, 32, 1280, 16, "random"),
    (3, 8, 40, 24, "random"),
    (1, 8, 4096, 16, "random"),  # two channel groups of 8
    (1, 8, 2048, 24, "random"),  # two groups of 12
    (1, 8, 1280, 24, "random"),  # the coarse levels' C at full width
    (2, 8, 1280, 32, "random"),
    (2, 16, 96, 32, "random"),
    (1, 12, 64, 24, "random"),   # B*H/4 odd: 3 clusters of 4 row blocks
    (1, 32, 1280, 16, "smooth"),  # shared taps
    (3, 4, 768, 16, "smooth"),
    (1, 8, 256, 16, "pile"),     # a whole row in one sort bin
])
def test_tile_warp_backward_kernel(dev, B, H, W, C, field):
    """Kernel 1's backward against its plain version.  The same floor()
    and sign decisions by construction; dhyp3 sums a tile's 16 pixels x C
    channels x 3 offsets in another order, dfea_r gathers up to 12 terms
    a value in the row's stable sort's order (index_add_'s atomics vary the
    plain version's): 1e-5 of each output's largest value, 1e-5 relative.
    dfea_l sums in the same order: equal.  A second launch gives all three
    the same bits (dhyp3 in a fixed order across the cluster's rows)."""
    hyp3, fl, fr, gout = _tile_warp_inputs(dev, B, H, W, C, field)
    got = _launched("tile_warp_cost_backward",
                    lambda: tile_warp.tile_warp_cost_backward(gout, hyp3, fl,
                                                              fr))
    ref = tile_warp.tile_warp_cost_backward_plain(gout, hyp3, fl, fr)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()),
                                   rtol=1e-5)
    assert torch.equal(got[1], ref[1])
    again = tile_warp.tile_warp_cost_backward(gout, hyp3, fl, fr)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tile_warp_autograd_launches_both_kernels(dev):
    """Under autograd tile_warp_cost launches the forward and, in
    backward(), the backward kernel, once each, in f32 and in bf16 (the
    exact form); the bf16 "pallas" form raises.  f32: each gradient within
    1e-5 of its largest value, 1e-5 relative, of the plain backward's;
    bf16: the bounds of test_tile_warp_backward_kernel_bf16 (dhyp3 and
    dfea_l in bits, dfea_r within one bf16 ulp plus n 2^-24 of its sum of
    |terms|)."""
    hyp3, fl, fr, gout = _tile_warp_inputs(dev, 2, 16, 64, 16)
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt).clone().requires_grad_() for t in (hyp3, fl, fr)]
        g = gout.to(dt)
        kernels.reset_counts()
        out = tile_warp.tile_warp_cost(*ins)
        out.backward(g)
        torch.cuda.synchronize()
        assert kernels.counts()["tile_warp_cost"] == 1
        assert kernels.counts()["tile_warp_cost_backward"] == 1
        plain = [t.detach() for t in ins]
        ref = tile_warp.tile_warp_cost_backward_plain(g, *plain)
        assert all(t.grad.dtype == dt for t in ins)
        if dt == torch.float32:
            for t, b in zip(ins, ref):
                torch.testing.assert_close(t.grad, b, atol=1e-5 * float(
                    b.abs().max()), rtol=1e-5)
            continue
        assert torch.equal(ins[0].grad, ref[0])
        assert torch.equal(ins[1].grad, ref[1])
        terms, n = tile_warp.tile_warp_cost_backward_terms(g, plain[0],
                                                           plain[2])
        assert ((ins[2].grad.float() - ref[2].float()).abs()
                <= 2.0 ** -7 * ref[2].float().abs()
                + n * 2.0 ** -24 * terms).all()
    with pytest.raises(NotImplementedError):
        tile_warp.tile_warp_cost(*[t.detach().to(torch.bfloat16)
                                   .requires_grad_() for t in ins],
                                 form="pallas")


@pytest.mark.parametrize("B,H,W,C,field", [
    (4, 384, 768, 16, "random"),  # the training call
    (1, 32, 1280, 16, "random"), (2, 8, 1280, 32, "random"),
    (1, 8, 4096, 16, "random"), (1, 12, 64, 24, "random"),
    (3, 4, 768, 16, "smooth"), (1, 8, 256, 16, "pile"),
])
def test_tile_warp_backward_kernel_bf16(dev, B, H, W, C, field):
    """Kernel 1's backward in bf16 (the VJP of the exact form) against its
    plain bf16 version: dhyp3 and dfea_l equal in bits (the same bf16
    steps in the same order); dfea_r within one bf16 ulp plus n 2^-24 of
    its sum of |terms| (f32 sums of a column's n tap cotangents in another
    order, one rounding); a second launch gives the same bits."""
    ins = [t.to(torch.bfloat16) for t in _tile_warp_inputs(dev, B, H, W, C,
                                                            field)]
    hyp3, fl, fr, gout = ins
    got = _launched("tile_warp_cost_backward",
                    lambda: tile_warp.tile_warp_cost_backward(gout, hyp3, fl,
                                                              fr))
    ref = tile_warp.tile_warp_cost_backward_plain(gout, hyp3, fl, fr)
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    terms, n = tile_warp.tile_warp_cost_backward_terms(gout, hyp3, fr)
    diff = (got[2].float() - ref[2].float()).abs()
    assert torch.isfinite(got[2]).all()
    assert (diff <= 2.0 ** -7 * ref[2].float().abs()
            + n * 2.0 ** -24 * terms).all()
    again = tile_warp.tile_warp_cost_backward(gout, hyp3, fl, fr)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# one process's hashes of kernel 1's bf16 backward at the training call
# (dhyp3, dfea_l, dfea_r) and of the plain version's dhyp3 and dfea_l
_BITS_SCRIPT = """
import hashlib, sys
import torch
sys.path[:0] = sys.argv[1:3]
from test_torch_gpu import _tile_warp_inputs
from codd_torch.ops import tile_warp
torch.backends.cudnn.allow_tf32 = False
ins = [t.to(torch.bfloat16) for t in _tile_warp_inputs(
    torch.device("cuda"), 4, 384, 768, 16, "random")]
hyp3, fl, fr, gout = ins
got = tile_warp.tile_warp_cost_backward(gout, hyp3, fl, fr)
ref = tile_warp.tile_warp_cost_backward_plain(gout, hyp3, fl, fr)
torch.cuda.synchronize()
print(" ".join(hashlib.sha1(t.cpu().view(torch.int16).numpy().tobytes())
               .hexdigest() for t in list(got) + list(ref[:2])))
"""


def test_tile_warp_backward_bf16_bits_across_processes(dev):
    """The training call's case of test_tile_warp_backward_kernel_bf16 in
    three processes of their own: the kernel's three outputs have the same
    bits in each (the row's sort is stable; ranks taken in the order of
    shared-memory atomics gave dfea_r other bits where a column's f32 sum
    rounds to two bf16 values), and dhyp3 and dfea_l are the plain
    version's."""
    here = Path(__file__).resolve().parent
    runs = []
    for _ in range(3):
        r = subprocess.run([sys.executable, "-c", _BITS_SCRIPT, str(here),
                            str(here.parent)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        runs.append(r.stdout.split()[-5:])
    assert all(h == runs[0] for h in runs), runs
    assert runs[0][:2] == runs[0][3:], runs[0]


@pytest.mark.parametrize("h,w,radius,B", [(12, 72, 32, 2), (5, 19, 3, 1),
                                         (7, 21, 3, 2), (13, 40, 32, 1),
                                         (48, 96, 32, 4)])
def test_gn_window_backward_kernel(dev, h, w, radius, B):
    """Kernel 5's backward against its plain backward, with ragged tiles
    (w not a multiple of 16, odd h), R = 3 and 32, and the motion stage's
    B = 4 at 48x96: each element within 1e-5 of its sum of |terms| (f32
    sums of the window's pairs in another order, its four products in
    3xTF32 on the tensor cores); two launches give the same bits."""
    ae, vals = _gn_inputs(dev, h, w, B)
    g = torch.randn(B, h, w, 27, generator=_g()).to(dev)
    got = _launched("gn_window_aggregate_backward",
                    lambda: gn.gn_window_aggregate_backward(g, ae, vals,
                                                            radius))
    ref = gn.gn_window_aggregate_backward_plain(g, ae, vals, radius)
    again = gn.gn_window_aggregate_backward(g, ae, vals, radius)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ta, tv = gn.gn_window_aggregate_backward_terms(g, ae, vals, radius)
    assert ((got[0] - ref[0]).abs() <= 1e-5 * ta + 1e-7).all()
    assert ((got[1] - ref[1]).abs() <= 1e-5 * tv + 1e-7).all()


def _bf16_within_ulp(got, ref):
    """Each element within one bf16 ulp of the larger of the two, plus
    1e-5 of the largest value (for the outputs that cancel to ~0)."""
    for a, b in [(got[0], ref[0])] + list(zip(got[1], ref[1])):
        assert a.dtype == b.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        big = torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        assert ((a - b).abs() <= ulp + 1e-5 * b.abs().max()).all()


@pytest.mark.parametrize("r,h,w,B", [(1, 12, 40, 2), (3, 12, 40, 2),
                                     (3, 13, 21, 2), (3, 48, 96, 4)])
def test_corr_patch_backward_kernel(dev, r, h, w, B, monkeypatch):
    """Kernel 6's backward against its plain backward, four levels, on a
    coherent and a scattered field (batch elements 0 and 1, then 2 and 3;
    ragged tiles where w is not a multiple of 8 or h of 4): both round f32
    sums once to bf16.  A block sums its own terms in a fixed order (the
    tensor-core products D F1 and box^T D), so df1, which has no atomics,
    gives equal bits on two launches; the levels meet one atomicAdd a
    block and pixel, in a run-dependent order across blocks.  So each
    element within one bf16 ulp of the larger of the two, plus 1e-5 of the
    largest value.  The scattered field's boxes take several chunks; with
    a budget of one m-tile every box goes in 16-pixel chunks (and runs of
    one row where the box is wider): the same tolerance."""
    g = _g()
    f1, f2 = (torch.randn(B, h, w, 128, generator=g).to(dev)
              for _ in range(2))
    coords = _corr_coords(dev, r, 2, h, w)
    coords = torch.cat([coords] * (B // 2)).contiguous()
    pyr = corr.build_corr_pyramid(f1, f2, 4, r, impl="patch")
    shapes = [tuple(l.shape[1:3]) for l in pyr["levels"]]
    plan = corr.patch_lookup_plan(coords, shapes, r, backward=True)
    assert plan[0].any() and not plan[0].all()
    gout = torch.randn(B, h, w, 4 * (2 * r + 1) ** 2, generator=g).to(dev)
    args = (gout, pyr["f1"], pyr["levels"], coords, r)
    got = _launched("corr_patch_lookup_backward",
                    lambda: corr.corr_patch_lookup_backward(*args))
    ref = corr.corr_patch_lookup_backward_plain(*args)
    _bf16_within_ulp(got, ref)
    assert torch.equal(corr.corr_patch_lookup_backward(*args)[0], got[0])
    monkeypatch.setattr(corr, "PATCH_BWD_BOX_BYTES", 0)
    small = corr.patch_lookup_plan(coords, shapes, r, backward=True)
    assert small[0].float().mean() < plan[0].float().mean()
    _bf16_within_ulp(corr.corr_patch_lookup_backward(*args), ref)


@pytest.mark.parametrize("r,h,w,B,L", [
    (3, 12, 40, 2, 4), (3, 13, 37, 4, 4), (1, 12, 40, 2, 4),
    (3, 12, 40, 2, 1), (3, 13, 37, 2, 2), (2, 13, 37, 2, 3)])
def test_corr_patch_coords_backward_kernel(dev, r, h, w, B, L, monkeypatch):
    """The lookup's coordinate gradient against its plain version, 1 to 4
    levels (a cluster of as many blocks), on a coherent and a scattered
    field with windows wholly and partly outside the levels (ragged tiles
    where w is not a multiple of 8 or h of 4), a tile none of whose
    windows meets level 0 (levels 1 and up do), a tile whose windows miss
    every level, and with 4 levels a whole level that no query reads
    (scale 1000): each element within 1e-5 of its sum of |terms|
    (``corr_patch_lookup_coords_backward_terms``: the tap dots are f32
    sums of 128 products in another order, and the derivative takes their
    differences); the same bits on two launches; boxes of one chunk and of
    several in one launch, and the same bits with every box in chunks of 8
    pixels (``PATCH_COORDS_BOX_BYTES = 0``: runs of one box row; a tap is
    its own column of one product, whatever the chunk); a query whose
    window misses every level has none."""
    g = _g()
    f1, f2 = (torch.randn(B, h, w, 128, generator=g).to(dev)
              for _ in range(2))
    coords = _corr_coords(dev, r, 2, h, w)
    coords[0, 0:4, 8:16] = torch.tensor([-(r + 1.5), 1.0])
    coords[0, 4:8, 16:24] = torch.tensor([-1000.0, 2.0])
    coords = torch.cat([coords] * (B // 2)).contiguous()
    pyr = corr.build_corr_pyramid(f1, f2, L, r, impl="patch")
    shapes = [tuple(l.shape[1:3]) for l in pyr["levels"]]
    plan = corr.patch_lookup_plan(coords, shapes, r, coords_grad=True)
    assert plan[0].any() and not plan[0].all()
    gout = torch.randn(B, h, w, L * (2 * r + 1) ** 2, generator=g).to(dev)
    scale_sets = [None] + ([[1.0, 0.5, 1000.0, 0.125]] if L == 4 else [])
    def check(scales):
        args = (gout, pyr["f1"], pyr["levels"], coords, r, scales)
        got = _launched("corr_patch_lookup_coords_backward",
                        lambda: corr.corr_patch_lookup_coords_backward(*args))
        ref = corr.corr_patch_lookup_coords_backward_plain(*args)
        terms = corr.corr_patch_lookup_coords_backward_terms(*args)
        assert torch.isfinite(got).all() and float(got.abs().max()) > 0
        assert bool(((got - ref).abs() <= 1e-5 * terms).all())
        assert not got[0, 4:8, 16:24].any()
        assert torch.equal(corr.corr_patch_lookup_coords_backward(*args),
                           got)
        return got

    results = [check(scales) for scales in scale_sets]
    monkeypatch.setattr(corr, "PATCH_COORDS_BOX_BYTES", 0)
    assert not corr.patch_lookup_plan(coords, shapes, r,
                                      coords_grad=True)[0].all()
    for scales, got in zip(scale_sets, results):
        assert torch.equal(check(scales), got)


def test_backward_kernels_under_autograd(dev):
    """Under autograd kernels 5 and 6 run as their Functions: the forward
    kernel and, in backward(), the backward kernel, once each; the
    gradients are the backward's."""
    ae, vals = _gn_inputs(dev)
    ta, tv = ae.clone().requires_grad_(), vals.clone().requires_grad_()
    gout = torch.randn(vals.shape, generator=_g()).to(dev)
    kernels.reset_counts()
    gn.gn_window_aggregate(ta, tv).backward(gout)
    torch.cuda.synchronize()
    assert kernels.counts()["gn_window_aggregate"] == 1
    assert kernels.counts()["gn_window_aggregate_backward"] == 1
    ref = gn.gn_window_aggregate_backward(gout, ae, vals)
    assert torch.equal(ta.grad, ref[0]) and torch.equal(tv.grad, ref[1])
    g = _g()
    f1, f2 = (torch.randn(1, 12, 40, 128, generator=g).to(dev)
              for _ in range(2))
    coords = _corr_coords(dev, 3, B=1)
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    pyr = corr.build_corr_pyramid(a, b, 4, 3, impl="patch")
    kernels.reset_counts()
    out = corr.corr_lookup(pyr, coords, 3)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert kernels.counts()["corr_patch_lookup"] == 1
    assert kernels.counts()["corr_patch_lookup_backward"] == 1
    assert kernels.counts()["corr_patch_lookup_coords_backward"] == 0
    assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()
    # coordinates that require grad: the coordinate kernel too, once
    c = coords.clone().requires_grad_()
    pyr = corr.build_corr_pyramid(f1, f2, 4, 3, impl="patch")
    kernels.reset_counts()
    out = corr.corr_lookup(pyr, c, 3)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert kernels.counts()["corr_patch_lookup_coords_backward"] == 1
    assert torch.equal(c.grad, corr.corr_patch_lookup_coords_backward(
        torch.ones_like(out), pyr["f1"], pyr["levels"], coords, 3))


def test_forward_only_kernels_raise_under_autograd(dev):
    """Kernels 2 and 3 have no backward, kernel 5 none for bf16 scores,
    and kernel 4 called directly (``composite``, not ``splat_render``'s
    ``SplatComposite``) none: asked for such a gradient, each wrapper
    raises instead of returning a tensor cut from the graph; under
    torch.no_grad() the same call launches."""
    g = _g()
    f1, f2 = (torch.randn(1, 12, 40, 128, generator=g).to(dev)
              for _ in range(2))
    coords = _corr_coords(dev, 3, B=1)
    vols = corr.build_corr_pyramid(f1, f2, 4, 3)
    ae, vals = _gn_inputs(dev)
    pts, intr, g = _splat_points(dev, 48, 80, False)
    order, offsets, alpha, Z = splat.sort_fragments(pts, intr, 48, 80, 1.0)
    feat = torch.randn(48 * 80, 6, generator=g).to(dev)
    need = lambda t: t.detach().clone().requires_grad_()  # noqa: E731
    calls = {
        "corr_lookup": lambda grad: corr.corr_lookup(
            [need(v) if grad else v for v in vols], coords, 3),
        "gn_fused_solve": lambda grad: gn.gn_fused_solve(
            need(ae) if grad else ae, vals),
        "gn_window_aggregate": lambda grad: gn.gn_window_aggregate(
            ae, need(vals) if grad else vals, bf16_scores=True),
        "splat_composite": lambda grad: splat.composite(
            order, offsets, alpha, Z.contiguous(),
            need(feat) if grad else feat),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call(True)
        with torch.no_grad():
            _launched(name, lambda: call(True))
        _launched(name, lambda: call(False))


def _train_batch(dev, B=1, T=2, H=64, W=128):
    g = _g()
    return {"l_img": torch.rand(B, T, H, W, 3, generator=g).to(dev),
            "r_img": torch.rand(B, T, H, W, 3, generator=g).to(dev),
            "gt_disp": (torch.rand(B, T, H, W, 1, generator=g) * 20 + 1
                        ).to(dev),
            "intrinsics": torch.tensor([[100.0, 100.0, W / 2, H / 2]] * B,
                                       device=dev)}


@pytest.mark.parametrize("stage", ["stereo", "fusion", "motion", "joint",
                                   "full"])
def test_training_step_on_the_card(dev, stage):
    """One step of each stage at 64x128, T=2: the stereo stage launches
    kernel 1 and its backward 9 times a frame; the fusion stage launches
    kernels 1-4 forward only (stereo and motion frozen) and no backward;
    the motion stage (stereo frozen, no fusion, 2 GN iterations, each
    checkpointed) kernels 5 and 6 twice an iteration forward and once
    backward, kernel 4 twice (forward only) and no volume or fused GN;
    the joint stage (stereo frozen, RAFT-3D and fusion trained) the same,
    with kernel 4's backward after each of its two splats; the full joint
    stage (nothing frozen) also kernel 1's backward 9 times a frame and
    the coordinate gradient once an iteration.  Finite loss; the frozen
    parameters keep their bits."""
    from codd_torch.losses.assembly import LossConfig
    from codd_torch.train import optim, trainer
    if stage == "stereo":
        model = CODD(max_disp=32, motion_type="none", fusion_type="none")
        lc = LossConfig(max_disp=32, motion=False, fusion=False)
        frozen = ()
    elif stage == "fusion":
        model = CODD(max_disp=32, iters=1, freeze_stereo=True,
                     freeze_motion=True)
        lc = LossConfig(max_disp=32, stereo=False, motion=False)
        frozen = ("stereo", "motion")
    elif stage == "motion":
        model = CODD(max_disp=32, iters=2, fusion_type="none",
                     freeze_stereo=True)
        lc = LossConfig(max_disp=32, stereo=False, fusion=False)
        frozen = ("stereo",)
    elif stage == "joint":
        model = CODD(max_disp=32, iters=2, freeze_stereo=True)
        lc = LossConfig(max_disp=32, stereo=False, motion_loss_weight=0.5)
        frozen = ("stereo",)
    else:
        model = CODD(max_disp=32, iters=2)
        lc = LossConfig(max_disp=32, motion_loss_weight=0.5)
        frozen = ()
    model = model.to(dev)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    tx = optim.make_optimizer(lambda s: 1e-3, 1.0, params, frozen)
    step = trainer.make_train_step(model, tx, lc)
    kernels.reset_counts()
    batch = _train_batch(dev)
    if stage in ("motion", "joint", "full"):
        batch["gt_flow"] = torch.zeros(batch["gt_disp"].shape[:-1] + (2,),
                                       device=dev)
        batch["gt_disp_change"] = torch.zeros_like(batch["gt_disp"])
    _, logs = step(trainer.create_train_state(model, tx), batch)
    torch.cuda.synchronize()
    counts = kernels.counts()
    assert torch.isfinite(logs["loss"]) and logs["step_skipped"].item() == 0
    if stage == "stereo":
        assert counts["tile_warp_cost"] == counts[
            "tile_warp_cost_backward"] == 18
    elif stage == "fusion":
        assert counts["tile_warp_cost_backward"] == 0
        assert counts["tile_warp_cost"] == 18
        assert min(counts["corr_lookup"], counts["gn_fused_solve"],
                   counts["splat_composite"]) > 0
    else:
        full = stage == "full"
        assert counts == {"tile_warp_cost": 18,
                          "tile_warp_cost_backward": 18 if full else 0,
                          "corr_lookup": 0, "gn_fused_solve": 0,
                          "splat_composite": 2, "gn_window_aggregate": 4,
                          "corr_patch_lookup": 4,
                          "gn_window_aggregate_backward": 2,
                          "corr_patch_lookup_backward": 2,
                          "splat_composite_backward":
                              0 if stage == "motion" else 2,
                          "corr_patch_lookup_coords_backward":
                              2 if full else 0}
    for k, p in params.items():
        if k.split(".")[0] in frozen:
            assert torch.equal(p.detach(), before[k]), k


@pytest.mark.parametrize("stage", ["stereo", "full"])
def test_bf16_training_step_on_the_card(dev, stage):
    """One step under bf16 compute (``make_train_step(bf16_compute=True)``)
    at 64x128, T=2, the stereo stage and the full joint model with 2 GN
    iterations: the launches of the f32 step; a finite loss; f32 masters
    and Adam moments."""
    from codd_torch.losses.assembly import LossConfig
    from codd_torch.train import optim, trainer
    if stage == "stereo":
        make = lambda: CODD(max_disp=32, motion_type="none",  # noqa: E731
                            fusion_type="none").to(dev)
        lc = LossConfig(max_disp=32, motion=False, fusion=False)
    else:
        make = lambda: CODD(max_disp=32, iters=2).to(dev)  # noqa: E731
        lc = LossConfig(max_disp=32, motion_loss_weight=0.5)
    batch = _train_batch(dev)
    if stage == "full":
        batch["gt_flow"] = torch.zeros(batch["gt_disp"].shape[:-1] + (2,),
                                       device=dev)
        batch["gt_disp_change"] = torch.zeros_like(batch["gt_disp"])
    counts = {}
    for bf16 in (False, True):
        model = make()
        tx = optim.make_optimizer(lambda s: 1e-3, 1.0)
        step = trainer.make_train_step(model, tx, lc, bf16_compute=bf16)
        kernels.reset_counts()
        state, logs = step(trainer.create_train_state(model, tx), batch)
        torch.cuda.synchronize()
        counts[bf16] = kernels.counts()
        assert torch.isfinite(logs["loss"]) and logs["step_skipped"] == 0
    assert counts[True] == counts[False]
    assert counts[True]["tile_warp_cost_backward"] == 18
    for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
        assert all(v.dtype == torch.float32 for v in tree.values())


def test_native_png_decoder_beside_the_card(dev, tmp_path):
    """The PNG codec builds with this machine's g++ and decodes rows of
    every filter type as read_png does."""
    import numpy as np
    from codd_torch.data import io as dio
    from codd_torch.data import native
    img = np.random.default_rng(0).integers(0, 256, (23, 31, 3)
                                            ).astype(np.uint8)
    p = str(tmp_path / "x.png")
    dio.write_png(p, img)
    assert np.array_equal(native.decode(p), img)
    assert np.array_equal(dio.imread(p), dio.read_png(p))


def test_train_estimator_step_on_the_card(dev, tmp_path):
    """One step of the training entry, PNG frames through the training
    pipeline (crop, photometric jitter) at 64x128, B=1, T=2, with the full
    joint model (max_disp 32, 2 GN iterations, nothing frozen): the full
    joint stage's launches, a finite loss, a checkpoint."""
    import json

    import numpy as np
    from codd_torch.apis.train import train_estimator
    from codd_torch.data.io import write_pfm, write_png
    rng = np.random.default_rng(1)
    lines = []
    for i in range(3):
        for side in ("left", "right"):
            (tmp_path / side).mkdir(exist_ok=True)
            write_png(str(tmp_path / side / f"{i:04d}.png"),
                       rng.integers(0, 256, (72, 136, 3)).astype(np.uint8))
        kinds = (("disp", (72, 136)), ("flow", (72, 136, 3)),
                 ("disp_change", (72, 136)))
        for kind, shape in kinds:
            (tmp_path / kind).mkdir(exist_ok=True)
            write_pfm(str(tmp_path / kind / f"{i:04d}.pfm"),
                      rng.uniform(1, 20, shape).astype(np.float32))
        lines.append(" ".join([f"{side}/{i:04d}.png"
                               for side in ("left", "right")]
                              + [f"{k}/{i:04d}.pfm" for k, _ in kinds]))
    (tmp_path / "split.txt").write_text("\n".join(lines) + "\n")
    cfg = {
        "model": {"stereo": {"initialization": {"max_disp": 32},
                             "loss": {"max_disp": 32}},
                  "motion": {"type": "Motion", "iters": 2,
                             "loss": {"loss_weight": 0.5}},
                  "fusion": {"type": "Fusion",
                             "loss": {"max_disp": 32}}},
        "data": {"train": {"preset": "scene_flow",
                           "split": str(tmp_path / "split.txt"),
                           "data_root": str(tmp_path), "num_frames": 2,
                           "batch_size": 1, "intrinsics": [100, 100, 68, 36],
                           "augment": {"crop_size": (64, 128),
                                       "photometric": True, "asym": True}}},
        "schedule": {"kind": "constant", "base_lr": 1e-4, "total_steps": 1},
        "runtime": {"log_interval": 1, "seed": 0},
        "checkpoint": {"interval": 1}}
    kernels.reset_counts()
    state, step = train_estimator(cfg, str(tmp_path / "work"), device="cuda",
                                  log=lambda *a: None)
    torch.cuda.synchronize()
    assert step == 1 and state.opt_state.count == 1
    rows = (tmp_path / "work" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 and np.isfinite(json.loads(rows[0])["loss"])
    assert kernels.counts() == {
        "tile_warp_cost": 18, "tile_warp_cost_backward": 18,
        "corr_lookup": 0, "gn_fused_solve": 0, "splat_composite": 2,
        "gn_window_aggregate": 4, "corr_patch_lookup": 4,
        "gn_window_aggregate_backward": 2, "corr_patch_lookup_backward": 2,
        "splat_composite_backward": 2, "corr_patch_lookup_coords_backward": 2}
    assert (tmp_path / "work" / "ckpt_1" / "state.pt").exists()
