"""The six CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and a small streaming run whose launch
counts show that every step went through them.  Marked ``gpu``; each test
skips itself when there is no CUDA card (chip_smoke.py runs the same
checks at the full 384x1280 shapes).  Torch only, so that it also runs
where JAX is not installed:
``python -m pytest tests/test_torch_gpu.py --noconftest -m gpu``."""

import contextlib
import pytest
import torch

from codd_torch.models.codd import CODD
from codd_torch.ops import corr, gn, kernels, se3, splat, tile_warp
from codd_torch.ops.projective import inv_project

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
    both in f32 before the one rounding), almost all equal."""
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
    with pytest.raises(NotImplementedError):
        corr.corr_patch_lookup_level(pyr["f1"], pyr["levels"][0],
                                     coords.clone().requires_grad_(), r)


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
                                "corr_patch_lookup": 0}
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
                                "corr_patch_lookup": 0}
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
                                "corr_patch_lookup": 4}
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["count"] > 0
