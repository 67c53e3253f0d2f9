"""Evaluation metrics (disparity, temporal, thresholded) as masked
reductions that stay on the tensors' device (counterpart of
``codd_tpu/ops/metrics.py``): every metric is a 0-d tensor, so a caller
can accumulate over frames and transfer once per sequence.
"""

from __future__ import annotations

import torch

__all__ = ["masked_mean", "epe_metric", "thres_metric", "t_epe_metric",
           "depth2normal"]


def masked_mean(x, mask):
    """Mean of x over mask; 0 if the mask is empty."""
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def epe_metric(d_est, d_gt, mask):
    """Mean absolute disparity error over valid pixels."""
    return masked_mean(torch.abs(d_est - d_gt), mask)


def thres_metric(d_est, d_gt, mask, thres: float):
    """Fraction of valid pixels with |err| > thres."""
    return masked_mean((torch.abs(d_est - d_gt) > thres).float(), mask)


def depth2normal(depth):
    """Normal map from a depth image (H, W) -> (H, W, 3) in [0, 1]."""
    zy, zx = torch.gradient(depth)
    normal = torch.stack([-zx, -zy, torch.ones_like(depth)], -1)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    return (normal + 1.0) / 2.0


def t_epe_metric(d_est_t0, d_gt_t0, d_est_t1, d_gt_t1, mask_t0, mask_t1):
    """Temporal EPE |dpred - dgt| between flow-aligned frames: (tepe mean,
    relative tepe mean, share > 3 px, share of relative > 1) over the joint
    mask."""
    mask = mask_t0 & mask_t1
    d_est = d_est_t0 - d_est_t1
    d_gt = d_gt_t0 - d_gt_t1
    abs_err = torch.abs(d_est - d_gt)
    rel_err = abs_err / (torch.abs(d_gt) + 1e-3)
    return (masked_mean(abs_err, mask), masked_mean(rel_err, mask),
            masked_mean((abs_err > 3.0).float(), mask),
            masked_mean((rel_err > 1.0).float(), mask))
