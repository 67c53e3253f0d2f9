"""Motion (RAFT-style sequence) and fusion losses (counterpart of
``codd_tpu/losses/temporal.py``).  An empty mask contributes 0."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..ops.metrics import masked_mean
from ..utils.precision import absolute

__all__ = ["motion_loss", "fusion_loss"]


def motion_loss(
    flow2d_est: List[torch.Tensor],   # per GN iteration (B,H,W,3) [fx, fy, dz]
    flow2d_rev: List[torch.Tensor],   # per GN iteration (B,H,W,2)
    flow_gt,                          # (B,H,W,3)
    mask,                             # (B,H,W,1) bool
    loss_weight: float = 1.0,
    rv_weight: float = 0.2,
    dz_weight: float = 210.0,
    gamma: float = 0.9,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Exponentially weighted sequence loss over the GN iterations; the
    means are over all pixels with the mask as a factor."""
    m = mask.to(flow_gt.dtype)
    fl_gt = flow_gt[..., :2]
    dz_gt = flow_gt[..., 2:]

    N = len(flow2d_est)
    total = 0.0
    for i in range(N):
        w = gamma ** (N - i - 1)
        fl_est = flow2d_est[i][..., :2]
        dz_est = flow2d_est[i][..., 2:]
        total = total + w * torch.mean(m * absolute(fl_est - fl_gt))
        total = total + w * dz_weight * torch.mean(
            m * absolute(dz_est - dz_gt))
        total = total + w * rv_weight * torch.mean(
            m * absolute(flow2d_rev[i] - fl_gt))

    # metrics of the last iteration
    epe2d = torch.sqrt(torch.sum((fl_est - fl_gt) ** 2, -1, keepdim=True))
    epedz = torch.abs(dz_est - dz_gt)
    logs = {
        "epe2d_warp": masked_mean(epe2d, mask),
        "epedz_warp": masked_mean(epedz, mask),
        "1px_warp": masked_mean((epe2d < 1).float(), mask),
        "3px_warp": masked_mean((epe2d < 3).float(), mask),
        "5px_warp": masked_mean((epe2d < 5).float(), mask),
    }
    return total * loss_weight, logs


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def fusion_loss(
    pred_disp,        # fused (B,H,W,1)
    gt_disp,
    fusion_weight,
    reset_weight,
    disp_curr,
    disp_warp,
    loss_weight: float = 1.0,
    wr_weight: float = 1.0,
    wf_weight: float = 1.0,
    min_disp: float = 1.0,
    max_disp: float = 320.0,
):
    """Smooth-L1 on the fused disparity plus hinge terms that supervise the
    fusion and reset weights by which of the current and the warped
    disparity is closer to the ground truth."""
    C1, C2 = 1.0, 5.0
    mask = (gt_disp >= min_disp) & (gt_disp <= max_disp)
    disp_l = masked_mean(_smooth_l1(pred_disp - gt_disp), mask)

    mask = mask & (disp_warp > 0)
    d = torch.abs(disp_curr - gt_disp) - torch.abs(disp_warp - gt_disp)

    def hinge(weight_warp, C, with_same):
        weight_curr = 1.0 - weight_warp
        out = (masked_mean(weight_warp, (d < -C) & mask)
               + masked_mean(weight_curr, (d > C) & mask))
        if with_same:
            same = masked_mean(absolute(weight_curr - 0.5),
                               (torch.abs(d) <= C) & mask)
            out = out + same * 0.2
        return out

    wf_l = hinge(fusion_weight, C1, with_same=True)
    wr_l = hinge(reset_weight, C2, with_same=False)
    return (disp_l + wf_l * wf_weight + wr_l * wr_weight) * loss_weight
