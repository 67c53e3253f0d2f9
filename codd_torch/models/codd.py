"""CODD estimator: stereo -> motion -> fusion over a cross-frame carry
(counterpart of ``codd_tpu/models/codd.py``, eval only).

    carry, out = model.first_step(left, right, intrinsics)   # frame 0
    carry, out = model.step(carry, left, right, intrinsics)  # frames t >= 1
    outs = model(left_seq, right_seq, intrinsics)            # a whole clip

Images are (B, H, W, 3), intrinsics (B, 4) ``[fx, fy, cx, cy]``.

``motion_type`` is "Motion" (RAFT-3D), "GTMotion" (ground-truth oracle) or
"none"; ``fusion_type`` is "Fusion" (the network), "NullFusion",
"GTFusion", "KalmanFusion" or "none".  The oracle variants read ground
truth from the ``gt`` argument of ``step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .fusion.fusion import Fusion
from .fusion.others import gt_fusion, kalman_fusion
from .motion.motion import Motion
from .motion.others import gt_motion
from .stereo.hitnet import HITNetStereo

__all__ = ["CODD", "CoddCarry", "MOTION_TYPES", "FUSION_TYPES"]

MOTION_TYPES = ("Motion", "GTMotion", "none")
FUSION_TYPES = ("Fusion", "NullFusion", "GTFusion", "KalmanFusion", "none")


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
                 fusion_channel: int = 32, stereo_feat_channels: int = 24,
                 motion_type: str = "Motion", fusion_type: str = "Fusion",
                 gn_impl: str = "auto", gn_bf16_scores: bool = False,
                 corr_impl: str = "auto", pixel_center_offset: float = 0.0,
                 tile_warp_variant: str = "auto"):
        super().__init__()
        if motion_type not in MOTION_TYPES or fusion_type not in FUSION_TYPES:
            raise ValueError(f"motion_type {motion_type!r} / fusion_type "
                             f"{fusion_type!r}: one of {MOTION_TYPES} / "
                             f"{FUSION_TYPES}")
        self.motion_type = motion_type
        self.fusion_type = fusion_type
        self.stereo = HITNetStereo(max_disp, tile_warp_variant)
        if motion_type == "Motion":
            self.motion = Motion(iters=iters, gn_impl=gn_impl,
                                 gn_bf16_scores=gn_bf16_scores,
                                 corr_impl=corr_impl,
                                 pixel_center_offset=pixel_center_offset)
        if fusion_type == "Fusion":
            self.fusion = Fusion(in_channels=stereo_feat_channels,
                                 fusion_channel=fusion_channel)

    def _project_feat(self, out):
        """Memory features: the fusion net's key projection, or the raw
        stereo features without a fusion net."""
        if self.fusion_type != "Fusion":
            return out["left_feat"]
        return self.fusion.project(out["left_feat"])

    @torch.no_grad()
    def first_step(self, left, right, intrinsics
                   ) -> Tuple[CoddCarry, Dict[str, Any]]:
        """Frame 0: stereo + feature caches; no motion/fusion compute."""
        out = self.stereo(left, right)
        B, H, W, _ = left.shape
        if self.motion_type == "Motion":
            fmap, netinp = self.motion.encode(left)
        else:
            fmap = left.new_zeros((B, H // 8, W // 8, 128))
            netinp = left.new_zeros((B, H // 8, W // 8, 512))
        carry = CoddCarry(
            memory_img=left, memory_feat=self._project_feat(out),
            memory_disp=out["pred_disp"][..., 0], fmap=fmap, netinp=netinp,
            kalman_p=left.new_zeros((B, H, W, 1)))
        return carry, out

    @torch.no_grad()
    def step(self, carry: CoddCarry, left, right, intrinsics,
             gt: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[CoddCarry, Dict[str, Any]]:
        """Frame t >= 1: the full stereo -> motion -> fusion cascade.
        ``gt`` holds this frame's ground truth for the oracle variants:
        GTMotion reads gt_flow / gt_disp_change / gt_flow_occ, GTFusion
        gt_disp."""
        out = self.stereo(left, right)
        pred_disp = out["pred_disp"]
        B, H, W, _ = left.shape
        fmap, netinp = carry.fmap, carry.netinp

        if self.motion_type == "Motion":
            memory5, raft_out, fmap, netinp = self.motion(
                left, pred_disp[..., 0], carry.memory_img, carry.memory_feat,
                carry.memory_disp, carry.fmap, carry.netinp, intrinsics)
            _, feat_warp, confidence_warp, disp_warp, flow_warp = memory5
            out.update(raft_out)
        elif self.motion_type == "GTMotion":
            memory5, out["Ts"] = gt_motion(
                carry.memory_img, carry.memory_feat, carry.memory_disp,
                gt["gt_flow"], gt["gt_disp_change"], gt["gt_flow_occ"])
            _, feat_warp, confidence_warp, disp_warp, flow_warp = memory5
        else:  # no motion: the memory passes through unwarped
            feat_warp = carry.memory_feat
            disp_warp = carry.memory_disp
            flow_warp = left.new_zeros((B, H, W, 3))
            confidence_warp = left.new_ones((B, H, W, 3))

        feat_curr = self._project_feat(out)
        kalman_p = carry.kalman_p
        if kalman_p is None:
            kalman_p = left.new_zeros((B, H, W, 1))

        if self.fusion_type == "Fusion":
            fused, wf, wr = self.fusion(
                pred_disp, disp_warp[..., None], feat_curr, feat_warp,
                flow_warp, confidence_warp, out["left_feat"],
                out["right_feat"])
            out["fusion_weights"] = wf
            out["reset_weights"] = wr
        elif self.fusion_type == "GTFusion":
            fused = gt_fusion(pred_disp, disp_warp[..., None], gt["gt_disp"])
        elif self.fusion_type == "KalmanFusion":
            fused, kalman_p = kalman_fusion(pred_disp, disp_warp[..., None],
                                            kalman_p)
        else:  # NullFusion / none: pred_disp stays the stereo output
            fused = None
        if fused is not None:
            out["pred_curr"] = pred_disp
            out["pred_warp"] = disp_warp[..., None]
            out["pred_disp"] = fused

        new_carry = CoddCarry(
            memory_img=left, memory_feat=feat_curr,
            memory_disp=out["pred_disp"][..., 0], fmap=fmap, netinp=netinp,
            kalman_p=kalman_p)
        return new_carry, out

    def forward(self, left_seq, right_seq, intrinsics, train: bool = False,
                gt_seq: Optional[Dict[str, torch.Tensor]] = None
                ) -> List[Dict[str, Any]]:
        """A clip (B, T, H, W, 3) frame by frame -> the per-frame output
        dicts.  Eval only: this package has no training path."""
        if train:
            raise NotImplementedError("codd_torch has no training path: "
                                      "call with train=False")
        carry, out = self.first_step(left_seq[:, 0], right_seq[:, 0],
                                     intrinsics)
        outs = [out]
        for t in range(1, left_seq.shape[1]):
            gt = (None if gt_seq is None else
                  {k: v[:, t] for k, v in gt_seq.items()})
            carry, out = self.step(carry, left_seq[:, t], right_seq[:, t],
                                   intrinsics, gt=gt)
            outs.append(out)
        return outs
