"""Resolution-change ops (counterpart of ``codd_tpu/ops/upsample.py``):
convex upsampling, slant-plane tile expansion, pixel unshuffle, nearest
and bilinear resize.  NHWC; channel orders match the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import se3
from .grid_sample import grid_sample
from ..utils.precision import softmax

__all__ = ["plane_offsets", "unfold3x3", "cvx_upsample", "upsample_se3",
           "to_plane", "hyp_upsample", "pixel_unshuffle",
           "interpolate_nearest", "interpolate_bilinear"]


def unfold3x3(x, dilation: int = 1):
    """3x3 neighbourhoods (B,H,W,C) -> (B,H,W,9,C), row-major (dy, dx)."""
    d = dilation
    H, W = x.shape[1:3]
    xp = F.pad(x, (0, 0, d, d, d, d))
    return torch.stack([xp[:, dy * d:dy * d + H, dx * d:dx * d + W, :]
                        for dy in range(3) for dx in range(3)], 3)


def cvx_upsample(data, mask, factor: int = 8):
    """RAFT convex upsampling.  data (B,h,w,C); mask (B,h,w,9*f*f) logits
    laid out (9, f, f).  Returns (B, h*f, w*f, C)."""
    B, h, w, C = data.shape
    f = factor
    m = softmax(mask.reshape(B, h, w, 9, f, f), 3)
    # a bf16 mask against f32 data computes in f32, as jnp.einsum promotes
    dt = torch.promote_types(data.dtype, mask.dtype)
    up = torch.einsum("bhwkyx,bhwkc->bhwyxc", m.to(dt),
                      unfold3x3(data.to(dt)))
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, h * f, w * f, C)


def upsample_se3(Ts, mask, factor: int = 8):
    """Upsample an SE3 field through the tangent space."""
    return se3.exp(cvx_upsample(se3.log(Ts), mask, factor))


def plane_offsets(size: int, dtype=torch.float32, device=None):
    """The ``size`` in-tile offsets ``-(size-1)/2 .. (size-1)/2``.

    Below f32 they take the values of ``codd_tpu``'s ``jnp.linspace`` in
    that dtype, whose arithmetic ``start * (1 - t) + stop * t`` rounds at
    each step: in bf16 at size 4 the second offset is -0.49609375, not
    -0.5 (a slant plane then moves by up to a pixel at large disparity).
    In f32 they are exact (``jnp.linspace`` gives -0.49999994 there; the
    port keeps -0.5, as kernel 1's f32 form does)."""
    if dtype == torch.float32:
        return torch.linspace(-(size - 1) / 2.0, (size - 1) / 2.0, size,
                              dtype=dtype, device=device)
    t = torch.arange(size, dtype=dtype, device=device) / (size - 1)
    half = (size - 1) / 2.0
    return -half * (1 - t) + half * t


def to_plane(d, dx, dy, size: int = 4):
    """Per-tile slant planes (B,h,w) -> per-pixel disparity
    (B, h*size, w*size) = d + a*dx + b*dy, a along x, b along y."""
    if d.ndim == 4:
        d, dx, dy = d[..., 0], dx[..., 0], dy[..., 0]
    B, h, w = d.shape
    c = plane_offsets(size, d.dtype, d.device)
    val = (d[:, :, None, :, None]
           + c[None, None, None, None, :] * dx[:, :, None, :, None]
           + c[None, None, :, None, None] * dy[:, :, None, :, None])
    return val.reshape(B, h * size, w * size)


def interpolate_nearest(x, scale: int):
    """Nearest upsample by an integer factor (NHWC)."""
    return x.repeat_interleave(scale, 1).repeat_interleave(scale, 2)


def interpolate_bilinear(x, out_hw, align_corners: bool = True):
    """Bilinear resize (NHWC) with torch align_corners semantics, border
    padding — the JAX package's grid-sample formulation."""
    B, H, W, C = x.shape
    oh, ow = out_hw
    kw = dict(dtype=torch.float32, device=x.device)
    if align_corners:
        ys = torch.linspace(0.0, H - 1.0, oh, **kw)
        xs = torch.linspace(0.0, W - 1.0, ow, **kw)
    else:
        ys = (torch.arange(oh, **kw) + 0.5) * (H / oh) - 0.5
        xs = (torch.arange(ow, **kw) + 0.5) * (W / ow) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy], -1)[None].expand(B, oh, ow, 2)
    return grid_sample(x, coords, mode="bilinear", padding_mode="border")


def hyp_upsample(h, scale: float, size: int = 2):
    """Tile-hypothesis upsampling: the disparity plane is expanded with
    the slant equation and scaled; other channels go nearest."""
    d = to_plane(h[..., 0], h[..., 1], h[..., 2], size=size) * scale
    return torch.cat([d[..., None], interpolate_nearest(h[..., 1:], size)], -1)


def pixel_unshuffle(x, factor: int):
    """torch PixelUnshuffle in NHWC: (B,H,W,C) -> (B,H/f,W/f,C*f*f),
    channel c*f*f + py*f + px."""
    B, H, W, C = x.shape
    f = factor
    x = x.reshape(B, H // f, f, W // f, f, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, H // f, W // f, C * f * f)
