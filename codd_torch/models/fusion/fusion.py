"""Recurrent fusion network (counterpart of
``codd_tpu/models/fusion/fusion.py``): blends the current stereo disparity
with the motion-warped previous one,
``disp = cur * (1 - wf*wr) + warp * wf*wr``, both weights gated by
``pred_warp > 0``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.gn import grad_clip
from ...ops.upsample import interpolate_nearest, unfold3x3
from ...ops.warp import disp_warp
from ...utils.precision import absolute
from ..layers import Conv, mish

__all__ = ["Fusion"]


class _MishBlock(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1)
        self.conv2 = Conv(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(mish(self.conv1(x)))


def _px2patch_corr(k, memory_k, self_corr: bool = False):
    """Pixel-to-patch correlation over 3x3 dilation-2 patches ->
    (B,H,W,9), or (B,H,W,8) without the centre (self-correlation)."""
    C = k.shape[-1]
    patches = unfold3x3(memory_k, dilation=2)            # (B,H,W,9,C)
    if C == 1:
        kk = k[..., None, 0] - patches[..., 0]
    else:
        kk = torch.sum(k[..., None, :] * patches, -1)
    if self_corr:
        kk = kk[..., [i for i in range(9) if i != 4]]
    return kk / math.sqrt(C)


class Fusion(nn.Module):
    def __init__(self, in_channels: int = 24, fusion_channel: int = 32,
                 ds_scale: int = 4):
        super().__init__()
        fc = fusion_channel
        self.in_channels = in_channels
        self.ds_scale = ds_scale
        self.key0 = Conv(in_channels, fc, 1)
        self.key_block = _MishBlock(fc)
        self.key1 = Conv(fc, fc, 1)
        self.conv_corr0 = Conv(31, fc * 2, 1)
        self.conv_corr1 = Conv(fc * 2, fc, 1)
        self.conv_disp0 = Conv(2, fc, 7, padding=3)
        self.conv_disp1 = Conv(fc, fc, 3, padding=1)
        self.motion_conv = Conv(2 * fc, fc - 2, 7, padding=3)
        self.residual_conv = Conv(2 * fc, fc, 3, padding=1)
        self.weight_head0 = Conv(fc, fc, 3, padding=1)
        self.weight_head1 = Conv(fc, 1, 1)
        self.forget_head0 = Conv(32, 16, 1)
        self.forget_head1 = Conv(16, 8, 3, padding=1)
        self.forget_head2 = Conv(8, 1, 1)

    def project(self, left_feat):
        """Stereo features -> fusion features (the key layer)."""
        x = F.relu(self.key0(left_feat))
        x = F.relu(self.key_block(x))
        return self.key1(x)

    def _disparity_confidence(self, pred_curr, pred_warp, fea_l, fea_r):
        s = self.ds_scale
        o = s // 2 - 1
        pc = pred_curr[:, o::s, o::s]
        pw = pred_warp[:, o::s, o::s]
        norm = self.in_channels / 24.0
        cvs_pred, cvs_warp = [], []
        for k in (-1.0, 0.0, 1.0):
            for pred, acc in ((pw, cvs_warp), (pc, cvs_pred)):
                warped, _ = disp_warp(fea_r, pred[..., 0] / s + k,
                                      padding_mode="zeros")
                acc.append(torch.sum(absolute(fea_l - warped), -1,
                                     keepdim=True) / norm)
        return torch.cat(cvs_pred, -1), torch.cat(cvs_warp, -1)

    def forward(self, pred_curr, pred_warp, feat_curr, feat_warp, flow_warp,
                confidence_warp, fea_l, fea_r):
        s = self.ds_scale
        cost_curr, cost_warp = self._disparity_confidence(
            pred_curr, pred_warp, fea_l, fea_r)
        feat_cross = _px2patch_corr(feat_curr, feat_warp)
        feat_self = torch.cat(
            [_px2patch_corr(feat_curr, feat_curr, self_corr=True),
             _px2patch_corr(feat_warp, feat_warp, self_corr=True)], -1)
        disp_cross = absolute(_px2patch_corr(pred_curr, pred_warp))
        disp_self = absolute(torch.cat(
            [_px2patch_corr(pred_curr, pred_curr, self_corr=True),
             _px2patch_corr(pred_warp, pred_warp, self_corr=True)], -1))
        corr_feat = torch.cat([feat_cross, feat_self, cost_curr, cost_warp],
                              -1)
        corr_feat_fr = torch.cat(
            [disp_cross, disp_self, flow_warp,
             (pred_warp > 0).to(pred_warp.dtype), confidence_warp], -1)

        o = s // 2 - 1
        pc = pred_curr[:, o::s, o::s]
        pw = pred_warp[:, o::s, o::s]
        corr = F.relu(self.conv_corr1(F.relu(self.conv_corr0(corr_feat))))
        disp = F.relu(self.conv_disp0(torch.cat([pc, pw], -1)))
        disp = F.relu(self.conv_disp1(disp))
        mo = F.relu(self.motion_conv(torch.cat([corr, disp], -1)))
        inp = torch.cat([feat_curr, mo, pc, pw], -1)
        net = F.relu(self.residual_conv(inp)) + corr

        w = self.weight_head1(self.weight_head0(net))
        fusion_weights = interpolate_nearest(torch.sigmoid(grad_clip(w)), s)
        r = self.forget_head2(self.forget_head1(self.forget_head0(
            corr_feat_fr)))
        reset_weights = torch.sigmoid(grad_clip(r))
        valid = (pred_warp > 0.0).to(pred_curr.dtype)
        fusion_weights = fusion_weights * valid
        reset_weights = reset_weights * valid
        wfr = fusion_weights * reset_weights
        disp_fused = pred_curr * (1.0 - wfr) + pred_warp * wfr
        return disp_fused, fusion_weights, reset_weights
