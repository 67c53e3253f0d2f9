"""Validity masks and ground-truth disparity change (counterpart of
``codd_tpu/utils/masks.py``).  ``disp_range`` comes from the dataset meta;
``BF_DEFAULT`` (= 210) caps flow magnitude and disparity change."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.warp import flow_warp

BF_DEFAULT = 1050 * 0.2

__all__ = ["compute_valid_mask", "compute_gt_disp_change", "BF_DEFAULT"]


def compute_valid_mask(gt_disp, disp_range: Tuple[float, float],
                       gt_semantic_seg: Optional[torch.Tensor] = None,
                       gt_flow_prev: Optional[torch.Tensor] = None,
                       gt_disp_change: Optional[torch.Tensor] = None):
    """gt_disp (B,H,W,1), gt_flow_prev (B,H,W,2), the rest (B,H,W,1) ->
    bool (B,H,W,1)."""
    mask = (gt_disp > disp_range[0]) & (gt_disp < disp_range[1])
    if gt_semantic_seg is not None:
        mask = mask & (gt_semantic_seg > 0)
    if gt_flow_prev is not None:
        mag = torch.sqrt(torch.sum(gt_flow_prev ** 2, -1, keepdim=True))
        mask = mask & (mag < BF_DEFAULT)
    if gt_disp_change is not None:
        mask = mask & (torch.abs(gt_disp_change) < BF_DEFAULT)
    return mask


def compute_gt_disp_change(gt_flow_occ_prev, gt_disp_prev, gt_disp_curr,
                           gt_flow):
    """Disparity change by flow-warping the next frame's disparity;
    occluded and out-of-view pixels get BF_DEFAULT, which
    ``compute_valid_mask`` excludes.  Returns (change, warped)."""
    warped, valid = flow_warp(gt_disp_curr, gt_flow, padding_mode="zeros",
                              mode="nearest")
    change = warped - gt_disp_prev
    fill = torch.full_like(change, BF_DEFAULT)
    change = torch.where(valid, change, fill)
    change = torch.where(gt_flow_occ_prev, fill, change)
    return change, warped
