"""Slant-plane tile-warp cost of HITNet propagation — kernel 1, its plain
float32 form.

For each 4x4 tile with hypothesis (d, dx, dy) the right features are warped
along the tile's slant plane at the offsets k in {-1, 0, +1}; the L1
distance to the left features, PixelUnshuffled(4), gives a (B, ht, wt, 48)
cost with channel ``k*16 + i*4 + j``.  Out-of-image taps read zero.  The
function ``codd_tpu/models/stereo/hitnet.py:tile_warping`` computes it in
XLA; ``codd_torch``'s ``csrc/tile_warp.cu`` on the card."""

from __future__ import annotations

import torch

from .upsample import pixel_unshuffle, to_plane
from .warp import meshgrid_xy

__all__ = ["tile_warp_cost"]


def _taps_f32(hyp3, fea_r):
    """Each pixel's four right-feature taps, out-of-image ones zero: the
    lerp fraction f (B,H,W,1), ok and the tap columns idx (B,H,W,4), and
    cols (B,H,W,4,C)."""
    B, H, W, C = fea_r.shape
    local_d = to_plane(hyp3[..., 0], hyp3[..., 1], hyp3[..., 2], size=4)
    x, _ = meshgrid_xy(H, W, fea_r.dtype, fea_r.device)
    p = x[None] - local_d
    x0 = torch.floor(p)
    taps = x0[..., None] - 1 + torch.arange(4, dtype=p.dtype, device=p.device)
    ok = (taps >= 0) & (taps <= W - 1)
    # out-of-image (and NaN) taps read column 0, masked below
    idx = torch.where(ok, taps, torch.zeros_like(taps)).long()
    cols = torch.gather(fea_r, 2, idx.reshape(B, H, W * 4, 1).expand(
        -1, -1, -1, C)).reshape(B, H, W, 4, C)
    return (p - x0)[..., None], ok, idx, cols * ok[..., None].to(fea_r.dtype)


def tile_warp_cost(hyp3, fea_l, fea_r):
    """hyp3 (B,ht,wt,3), fea_l/fea_r (B,H,W,C) f32 -> (B,ht,wt,48)."""
    f, _, _, cols = _taps_f32(hyp3, fea_r)
    cvs = []
    # k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
    for j in (2, 1, 0):
        warped = cols[..., j, :] * (1 - f) + cols[..., j + 1, :] * f
        cv = torch.sum(torch.abs(fea_l - warped), -1, keepdim=True)
        cvs.append(pixel_unshuffle(cv, 4))
    return torch.cat(cvs, -1)
