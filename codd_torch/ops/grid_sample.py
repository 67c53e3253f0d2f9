"""Image resampling with ``align_corners=True`` grid-sample semantics in
pixel coordinates (counterpart of ``codd_tpu/ops/grid_sample.py``).

Written as explicit integer gathers rather than ``F.grid_sample`` so the
corner clamping, zero masks and interpolation order are those of the
JAX reference, term for term.  NHWC images, ``(x, y)`` pixel coords.
"""

from __future__ import annotations

import torch

__all__ = ["grid_sample"]


def _gather_2d(img, ix, iy):
    """img[b, iy, ix, :] for clamped integer maps ix/iy (B, *Q)."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    idx = (iy * W + ix).reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(flat, 1, idx).reshape(*ix.shape, C)


def grid_sample(img, coords, mode: str = "bilinear",
                padding_mode: str = "zeros"):
    """Sample img (B,H,W,C) at coords (B,*Q,2) = (x, y) pixels, mode
    "bilinear" or "nearest", with "zeros" or "border" padding.  Returns
    (B,*Q,C)."""
    B, H, W, C = img.shape
    x = coords[..., 0]
    y = coords[..., 1]
    if mode == "nearest":
        # round half to even, like jnp.round and torch's nearbyint
        xr = torch.round(x)
        yr = torch.round(y)
        out = _gather_2d(img, xr.clamp(0, W - 1).long(),
                         yr.clamp(0, H - 1).long())
        if padding_mode == "zeros":
            valid = (xr >= 0) & (xr <= W - 1) & (yr >= 0) & (yr <= H - 1)
            out = out * valid[..., None].to(img.dtype)
        return out
    if mode != "bilinear":
        raise ValueError(f"unsupported mode: {mode}")

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(img.dtype)[..., None]
    wy = (y - y0f).to(img.dtype)[..., None]

    def corner(xf, yf):
        v = _gather_2d(img, xf.clamp(0, W - 1).long(),
                       yf.clamp(0, H - 1).long())
        if padding_mode == "zeros":
            ok = (xf >= 0) & (xf <= W - 1) & (yf >= 0) & (yf <= H - 1)
            v = v * ok[..., None].to(img.dtype)
        return v

    v00 = corner(x0f, y0f)
    v01 = corner(x0f + 1, y0f)
    v10 = corner(x0f, y0f + 1)
    v11 = corner(x0f + 1, y0f + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
