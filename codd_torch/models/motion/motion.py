"""Motion module: RAFT-3D + forward warping of the cross-frame memory
(counterpart of ``codd_tpu/models/motion/motion.py``, ``warp_image=False``).

Converts disparities to clipped depth, estimates the dense SE(3) field,
then splats (kernel 4) the induced flow and confidence at full res
(C=6, r=1 px) and the fusion features at 1/4 res (C=32, r=2 px) into the
current frame.  In training (``train_mode``) RAFT-3D runs its train
branch.  With ``warp_grad`` (``CODD`` sets it where a trainable fusion
reads the warped memory) the splats run under autograd, differentiable
in the points and the features (``ops/splat.py:SplatComposite``, kernel
4 and its backward), as ``codd_tpu``'s training splat; without it they
run under ``torch.no_grad()``: kernel 4's forward, nothing saved, no loss
reaching the warped memory (the motion stage, or a frozen fusion, which
``codd_tpu`` stops at its outputs).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ...ops import se3
from ...ops.projective import inv_project
from ...ops.splat import splat_render
from .raft3d import RAFT3D

from ...utils.masks import BF_DEFAULT  # baseline * focal = 210
from ...utils.precision import rdiv
from ...utils.spans import span

__all__ = ["Motion", "BF_DEFAULT", "disp_to_depth"]


def disp_to_depth(disp):
    """Disparity -> depth (up to scale), clipped to [0, BF_DEFAULT]."""
    return rdiv(BF_DEFAULT, disp + 1e-5).clamp(0.0, BF_DEFAULT)


class Motion(nn.Module):
    def __init__(self, iters: int = 16, ds_scale: int = 4,
                 gn_impl: str = "auto", gn_bf16_scores: bool = False,
                 corr_impl: str = "auto", pixel_center_offset: float = 0.0):
        super().__init__()
        self.ds_scale = ds_scale
        # 0.0 = integer pixel centres; -0.5 = pytorch3d's half-integer
        # screen convention, for weights trained with the original
        self.pixel_center_offset = pixel_center_offset
        self.raft3d = RAFT3D(iters=iters, gn_impl=gn_impl,
                             gn_bf16_scores=gn_bf16_scores,
                             corr_impl=corr_impl)

    def encode(self, image):
        return self.raft3d.encode(image)

    def forward(self, img_curr, disp_curr, memory_img, memory_feat,
                memory_disp, fmap_prev, netinp_prev, intrinsics,
                train_mode: bool = False, warp_grad: bool = False):
        """Returns (warped 5-slot memory, raft outputs, fmap, netinp)."""
        depth_prev = disp_to_depth(memory_disp)
        depth_curr = disp_to_depth(disp_curr)
        raft_out, fmap_curr, netinp_curr = self.raft3d(
            img_curr, depth_prev, depth_curr, intrinsics, fmap_prev,
            netinp_prev, train_mode=train_mode)
        # no loss reaches the warped memory without warp_grad (docstring)
        with contextlib.nullcontext() if warp_grad else torch.no_grad(), \
                span("motion.splat"):
            memory5 = self._warp(img_curr, raft_out, memory_img, memory_feat,
                                 depth_prev, intrinsics)
        return memory5, raft_out, fmap_curr, netinp_curr

    def _warp(self, img_curr, raft_out, memory_img, memory_feat, depth_prev,
              intrinsics):
        """Both splats: the induced flow and confidence at full res, the
        memory features at 1/ds_scale res."""
        B, H, W, _ = img_curr.shape
        Ts = raft_out["Ts"]

        to_proj = torch.cat([raft_out["flow2d_est_induced"],
                             raft_out["weight"]], -1)
        X2 = se3.act(Ts, inv_project(depth_prev, intrinsics))
        warped, zbuf = splat_render(
            X2.reshape(B, -1, 3), to_proj.reshape(B, -1, to_proj.shape[-1]),
            intrinsics, H=H, W=W, radius_px=1.0,
            pixel_center_offset=self.pixel_center_offset)
        img_warp = torch.zeros_like(memory_img)
        flow_warp = warped[..., :3]
        confidence_warp = warped[..., 3:6]
        disp_warp = rdiv(BF_DEFAULT, zbuf + 1e-5)
        disp_warp = torch.where(disp_warp > W, torch.zeros_like(disp_warp),
                                disp_warp)

        s = self.ds_scale
        o = s // 2 - 1
        intr_lr = intrinsics / s
        X2l = se3.act(Ts[:, o::s, o::s],
                      inv_project(depth_prev[:, o::s, o::s], intr_lr))
        C = memory_feat.shape[-1]
        feat_warp, _ = splat_render(
            X2l.reshape(B, -1, 3), memory_feat.reshape(B, -1, C), intr_lr,
            H=H // s, W=W // s, radius_px=2.0,
            pixel_center_offset=self.pixel_center_offset)
        return (img_warp, feat_warp, confidence_warp, disp_warp, flow_warp)
