"""Flow / disparity warping with validity masks (counterpart of
``codd_tpu/ops/warp.py``).  NHWC; flow is (B,H,W,2) in (dx, dy) pixels."""

from __future__ import annotations

import torch

from .grid_sample import clamp_index, grid_sample

__all__ = ["meshgrid_xy", "disp_warp"]


def meshgrid_xy(h: int, w: int, dtype=torch.float32, device=None):
    """(h, w) maps of x and y pixel coordinates."""
    x = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    y = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return x, y


def disp_warp(img, disp, padding_mode: str = "border"):
    """Backward-warp the right image img (B,H,W,C) by disparity (B,H,W) or
    (B,H,W,1).  Horizontal 2-tap sample.  Returns (warped, valid)."""
    if disp.ndim == 4:
        disp = disp[..., 0]
    B, H, W, C = img.shape
    x, _ = meshgrid_xy(H, W, img.dtype, img.device)
    warped, inb = _hwarp(img, x[None] - disp, padding_mode)
    return warped, inb[..., None].expand(warped.shape)


def _hwarp(img, xs, padding_mode: str):
    """img (B,H,W,C) sampled at x-coords xs (B,H,W) along each row.
    Returns (warped, in_bounds (B,H,W)): in_bounds is the weight mass of
    in-image taps >= 0.9999, i.e. ones warped with zero padding."""
    B, H, W, C = img.shape
    x0f = torch.floor(xs)
    wx = (xs - x0f).to(img.dtype)[..., None]

    def tap(xf):
        xi = clamp_index(xf, W)[..., None].expand(-1, -1, -1, C)
        v = torch.gather(img, 2, xi)
        if padding_mode == "zeros":
            v = v * ((xf >= 0) & (xf <= W - 1))[..., None].to(img.dtype)
        return v

    warped = tap(x0f) * (1 - wx) + tap(x0f + 1) * wx
    ok0 = ((x0f >= 0) & (x0f <= W - 1)).to(img.dtype)
    ok1 = ((x0f + 1 >= 0) & (x0f + 1 <= W - 1)).to(img.dtype)
    mass = ok0 * (1 - wx[..., 0]) + ok1 * wx[..., 0]
    return warped, mass >= 0.9999
