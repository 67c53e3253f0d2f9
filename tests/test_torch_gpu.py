"""The four CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and a small streaming run whose launch
counts show that every step went through them.  Marked ``gpu``; each test
skips itself when there is no CUDA card (chip_smoke.py runs the same
checks at the full 384x1280 shapes).  Torch only, so that it also runs
where JAX is not installed:
``python -m pytest tests/test_torch_gpu.py --noconftest -m gpu``."""

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


def test_corr_lookup_kernel(dev):
    g = _g()
    f1, f2 = (torch.randn(2, 12, 20, 64, generator=g).to(dev)
              for _ in range(2))
    vols = corr.build_corr_pyramid(f1, f2, 4, 3)
    coords = (torch.rand(2, 12, 20, 2, generator=g) * 30 - 5).to(dev)
    for lvl, vol in enumerate(vols):
        got = _launched("corr_lookup", lambda: corr.corr_lookup_level(
            vol, coords, 3, 1.0 / 2 ** lvl))
        ref = corr.corr_lookup_level_plain(vol, coords / 2 ** lvl, 3)
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_gn_fused_kernel(dev):
    g = _g()
    h, w = 12, 72   # a partial 32-query block at the right edge
    depth = (torch.rand(1, h, w, generator=g) * 30 + 2).to(dev)
    intr = torch.tensor([[60.0, 60.0, w / 2, h / 2]], device=dev)
    Ts = se3.exp((torch.randn(1, h, w, 6, generator=g) * 0.01).to(dev))
    target = torch.randn(1, h, w, 3, generator=g).to(dev)
    weight = torch.rand(1, h, w, 3, generator=g).to(dev)
    vals = gn.build_vals(Ts, target, weight, depth, intr).contiguous()
    ae = (torch.randn(1, h, w, 32, generator=g) / 8).to(dev)
    got = _launched("gn_fused_solve", lambda: gn.gn_fused_solve(ae, vals))
    ref = gn.gn_fused_solve_plain(ae, vals)
    torch.testing.assert_close(got, ref, atol=1e-5,
                               rtol=1e-3)


def test_splat_composite_kernel(dev):
    g = _g()
    h, w = 48, 80
    intr = torch.tensor([60.0, 60.0, w / 2, h / 2], device=dev)
    depth = (torch.rand(1, h, w, generator=g) * 30 + 2).to(dev)
    pts = se3.act(se3.exp((torch.randn(1, h, w, 6, generator=g) * 0.01)
                          .to(dev)), inv_project(depth, intr[None]))
    feat = torch.randn(h * w, 32, generator=g).to(dev)
    order, offsets, alpha, Z = splat.sort_fragments(pts.reshape(-1, 3), intr,
                                                    h, w, 2.0)
    args = (order, offsets, alpha, Z.contiguous(), feat)
    got = _launched("splat_composite", lambda: splat.composite(*args))
    ref = splat.composite_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


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
    # 9 tile warps a frame; 4 corr levels, 1 GN solve an iteration; 2 splats
    assert kernels.counts() == {"tile_warp_cost": 27, "corr_lookup": 16,
                                "gn_fused_solve": 4, "splat_composite": 4}
    assert torch.isfinite(out["pred_disp"]).all()
