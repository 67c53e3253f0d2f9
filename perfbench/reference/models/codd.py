"""CODD estimator: stereo -> motion -> fusion over a cross-frame carry
(counterpart of ``codd_tpu/models/codd.py``), its eval path with RAFT-3D
and the fusion network, as ``configs/models/codd.py`` builds it.

    carry, out = model.first_step(left, right, intrinsics)   # frame 0
    carry, out = model.step(carry, left, right, intrinsics)  # frames t >= 1

Images are (B, H, W, 3), intrinsics (B, 4) ``[fx, fy, cx, cy]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .fusion.fusion import Fusion
from .motion.motion import Motion
from .stereo.hitnet import HITNetStereo

__all__ = ["CODD", "CoddCarry"]


@dataclasses.dataclass
class CoddCarry:
    """Cross-frame memory, as ``codd_tpu``'s ``CoddCarry``."""

    memory_img: torch.Tensor    # (B, H, W, 3)     previous left image
    memory_feat: torch.Tensor   # (B, H/4, W/4, C) previous (projected) features
    memory_disp: torch.Tensor   # (B, H, W)        previous fused disparity
    fmap: torch.Tensor          # (B, H/8, W/8, 128) RAFT features
    netinp: torch.Tensor        # (B, H/8, W/8, 512) RAFT context
    kalman_p: Optional[torch.Tensor] = None  # (B, H, W, 1) Kalman covariance


class CODD(nn.Module):
    def __init__(self, max_disp: int = 320, iters: int = 16,
                 fusion_channel: int = 32, stereo_feat_channels: int = 24):
        super().__init__()
        self.stereo = HITNetStereo(max_disp)
        self.motion = Motion(iters=iters)
        self.fusion = Fusion(in_channels=stereo_feat_channels,
                             fusion_channel=fusion_channel)

    def first_step(self, left, right, intrinsics
                   ) -> Tuple[CoddCarry, Dict[str, Any]]:
        """Frame 0: stereo + feature caches; no motion/fusion compute."""
        out = self.stereo(left, right)
        B, H, W, _ = left.shape
        fmap, netinp = self.motion.encode(left)
        carry = CoddCarry(
            memory_img=left, memory_feat=self.fusion.project(out["left_feat"]),
            memory_disp=out["pred_disp"][..., 0], fmap=fmap, netinp=netinp,
            kalman_p=left.new_zeros((B, H, W, 1)))
        return carry, out

    def step(self, carry: CoddCarry, left, right, intrinsics
             ) -> Tuple[CoddCarry, Dict[str, Any]]:
        """Frame t >= 1: the full stereo -> motion -> fusion cascade."""
        out = self.stereo(left, right)
        pred_disp = out["pred_disp"]
        memory5, raft_out, fmap, netinp = self.motion(
            left, pred_disp[..., 0], carry.memory_img, carry.memory_feat,
            carry.memory_disp, carry.fmap, carry.netinp, intrinsics)
        _, feat_warp, confidence_warp, disp_warp, flow_warp = memory5
        out.update(raft_out)
        feat_curr = self.fusion.project(out["left_feat"])
        fused, wf, wr = self.fusion(
            pred_disp, disp_warp[..., None], feat_curr, feat_warp, flow_warp,
            confidence_warp, out["left_feat"], out["right_feat"])
        out["fusion_weights"] = wf
        out["reset_weights"] = wr
        out["pred_curr"] = pred_disp
        out["pred_warp"] = disp_warp[..., None]
        out["pred_disp"] = fused
        kalman_p = carry.kalman_p
        if kalman_p is None:
            kalman_p = left.new_zeros(left.shape[:3] + (1,))
        new_carry = CoddCarry(
            memory_img=left, memory_feat=feat_curr,
            memory_disp=out["pred_disp"][..., 0], fmap=fmap, netinp=netinp,
            kalman_p=kalman_p)
        return new_carry, out
