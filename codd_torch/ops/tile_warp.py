"""Slant-plane tile-warp cost of HITNet propagation — kernel 1.

For each 4x4 tile with hypothesis (d, dx, dy) the right features are warped
along the tile's slant plane at the offsets k in {-1, 0, +1}; the L1
distance to the left features, PixelUnshuffled(4), gives a (B, ht, wt, 48)
cost with channel ``k*16 + i*4 + j``.  Out-of-image taps read zero.

Replaces the TPU kernel ``codd_tpu/ops/pallas/tile_warp.py:tile_warp_cost``
(``pl.pallas_call`` at :123); its XLA oracle, and the function
``tile_warp_cost_plain`` below computes, is
``codd_tpu/models/stereo/hitnet.py:tile_warping``.

On the H100 (``csrc/tile_warp.cu``): one thread per pixel.  The work is
~24 flops per channel per pixel against (2C+3/16)*4 bytes read, so the
kernel is bound by bytes: 69 MB at the full-res call (384x1280, C=16), a
20 us floor at 3.35 TB/s.  The design reads each left feature once, the
four right taps as plain global loads (they sit up to ``max_disp``
columns away on the same row, which L1/L2 serve), and never materialises
the warped features the XLA path gathers into device memory.  The plane
and lerp arithmetic uses round-to-nearest intrinsics so that no FMA
contraction moves ``floor()`` off the plain version.
"""

from __future__ import annotations

import torch

from . import kernels
from .upsample import pixel_unshuffle, to_plane
from .warp import meshgrid_xy

__all__ = ["tile_warp_cost", "tile_warp_cost_plain"]


def tile_warp_cost_plain(hyp3, fea_l, fea_r):
    """hyp3 (B,ht,wt,3), fea_l/fea_r (B,H,W,C) -> (B,ht,wt,48)."""
    B, H, W, C = fea_r.shape
    local_d = to_plane(hyp3[..., 0], hyp3[..., 1], hyp3[..., 2], size=4)
    x, _ = meshgrid_xy(H, W, fea_r.dtype, fea_r.device)
    p = x[None] - local_d
    x0 = torch.floor(p)
    f = (p - x0)[..., None]
    taps = x0[..., None] - 1 + torch.arange(4, dtype=p.dtype, device=p.device)
    ok = (taps >= 0) & (taps <= W - 1)
    idx = taps.clamp(0, W - 1).long()                           # (B,H,W,4)
    cols = torch.gather(fea_r, 2, idx.reshape(B, H, W * 4, 1).expand(
        -1, -1, -1, C)).reshape(B, H, W, 4, C)
    cols = cols * ok[..., None].to(fea_r.dtype)
    cvs = []
    # k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
    for j in (2, 1, 0):
        warped = cols[..., j, :] * (1 - f) + cols[..., j + 1, :] * f
        cv = torch.sum(torch.abs(fea_l - warped), -1, keepdim=True)
        cvs.append(pixel_unshuffle(cv, 4))
    return torch.cat(cvs, -1)


def tile_warp_cost(hyp3, fea_l, fea_r):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if not fea_r.is_cuda:
        return tile_warp_cost_plain(hyp3, fea_l, fea_r)
    B, H, W, C = fea_r.shape
    ht, wt = H // 4, W // 4
    kernels.check_cuda("tile_warp_cost", hyp3, fea_l, fea_r,
                       dtypes=(torch.float32,) * 3)
    if (H % 4 or W % 4 or C % 4 or tuple(fea_l.shape) != (B, H, W, C)
            or tuple(hyp3.shape) != (B, ht, wt, 3)):
        raise ValueError(f"tile_warp_cost: bad shapes hyp3 {tuple(hyp3.shape)}"
                         f" fea_l {tuple(fea_l.shape)} fea_r {(B, H, W, C)}")
    out = torch.empty((B, ht, wt, 48), dtype=torch.float32,
                      device=fea_r.device)
    kernels.launch("tile_warp_cost", hyp3.data_ptr(), fea_l.data_ptr(),
                   fea_r.data_ptr(), out.data_ptr(), B, H, W, C,
                   kernels.stream_ptr(fea_r.device))
    return out
