"""Pinhole projection on dense depth / point fields (counterpart of
``codd_tpu/ops/projective.py``).  Depth (B,H,W), intrinsics (B,4) as
``[fx, fy, cx, cy]``, points (B,H,W,3)."""

from __future__ import annotations

import torch

from . import se3
from .warp import meshgrid_xy

MIN_DEPTH = 0.05
EPS = 1e-5

__all__ = ["project", "inv_project", "projective_transform", "induced_flow",
           "MIN_DEPTH"]


def _intr(intrinsics):
    return [intrinsics[:, i, None, None] for i in range(4)]


def project(points, intrinsics):
    """Points (B,H,W,3) -> (B,H,W,3) = [x, y, 1/Z]."""
    X, Y, Z = points.unbind(-1)
    Z = Z + EPS
    fx, fy, cx, cy = _intr(intrinsics)
    return torch.stack([fx * (X / Z) + cx, fy * (Y / Z) + cy, 1.0 / Z],
                       -1)


def inv_project(depth, intrinsics):
    """Depth (B,H,W) -> camera-space points (B,H,W,3)."""
    H, W = depth.shape[-2:]
    fx, fy, cx, cy = _intr(intrinsics)
    x, y = meshgrid_xy(H, W, depth.dtype, depth.device)
    X = depth * ((x[None] - cx) / fx)
    Y = depth * ((y[None] - cy) / fy)
    return torch.stack([X, Y, depth], -1)


def projective_transform(Ts, depth, intrinsics):
    """Apply the SE3 field Ts (B,H,W,7) and reproject.
    Returns (coords (B,H,W,3), valid (B,H,W) float)."""
    X0 = inv_project(depth, intrinsics)
    X1 = se3.act(Ts, X0)
    valid = (X0[..., 2] > MIN_DEPTH) & (X1[..., 2] > MIN_DEPTH)
    return project(X1, intrinsics), valid.to(depth.dtype)


def induced_flow(Ts, depth, intrinsics):
    """2D+invdepth flow and 3D flow induced by Ts.
    Returns (flow2d (B,H,W,3), flow3d (B,H,W,3), valid (B,H,W) float)."""
    X0 = inv_project(depth, intrinsics)
    X1 = se3.act(Ts, X0)
    valid = (X0[..., 2] > MIN_DEPTH) & (X1[..., 2] > MIN_DEPTH)
    return (project(X1, intrinsics) - project(X0, intrinsics), X1 - X0,
            valid.to(depth.dtype))
