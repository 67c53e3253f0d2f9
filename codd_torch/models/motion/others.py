"""Ground-truth oracle motion: warp the memory by the ground-truth flow
and disparity change (counterpart of ``codd_tpu/models/motion/others.py``).
A parameter-free stand-in for RAFT-3D that produces the same 5-slot
warped memory and an identity transform field."""

from __future__ import annotations

import torch

from ...ops import se3
from ...ops.warp import flow_warp

__all__ = ["gt_motion"]


def gt_motion(memory_img, memory_feat, memory_disp, gt_flow, gt_disp_change,
              gt_flow_occ):
    """memory_disp (B,H,W); gt_flow (B,H,W,2); gt_disp_change / gt_flow_occ
    (B,H,W,1).  Occluded (occ > 0) and out-of-view pixels are zeroed.
    Returns (memory5, identity Ts (B,H,W,7))."""
    B, H, W, _ = memory_img.shape
    occ = gt_flow_occ > 0

    to_warp = torch.cat([memory_img, memory_disp[..., None]], -1)
    warped, valid = flow_warp(to_warp, gt_flow, padding_mode="zeros",
                              mode="nearest")
    zero = torch.zeros_like(warped)
    warped = torch.where(valid, warped, zero)
    warped = torch.where(occ, zero, warped)
    img_warp = warped[..., :3]
    disp_warp = warped[..., 3:4] - gt_disp_change
    disp_warp = torch.where(valid[..., 3:4], disp_warp, zero[..., 3:4])
    disp_warp = torch.where(occ, zero[..., 3:4], disp_warp)

    # quirk of the original model, kept: the 1/4-res feature warp reuses
    # the full-res flow values subsampled at [2::4] without rescaling
    feat_warp, fvalid = flow_warp(memory_feat, gt_flow[:, 2::4, 2::4],
                                  padding_mode="zeros", mode="nearest")
    feat_warp = torch.where(fvalid, feat_warp, torch.zeros_like(feat_warp))

    flow_mem = torch.cat([gt_flow, gt_disp_change], -1)
    confidence = torch.ones_like(flow_mem)
    Ts = se3.identity((B, H, W), memory_img.dtype, memory_img.device)
    memory5 = (img_warp, feat_warp, confidence, disp_warp[..., 0], flow_mem)
    return memory5, Ts
