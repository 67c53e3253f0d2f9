"""Parameter-free fusion baselines: ground-truth oracle and Kalman
(counterpart of ``codd_tpu/models/fusion/others.py``).  Pure functions;
the estimator dispatches on its ``fusion_type``."""

from __future__ import annotations

import torch

__all__ = ["gt_fusion", "kalman_fusion"]


def gt_fusion(pred_disp, pred_warp, gt_disp):
    """Oracle: per pixel whichever of current / warped is closer to the
    ground truth; their mean when the errors are within 1 px of each
    other."""
    err_curr = torch.abs(pred_disp - gt_disp)
    err_warp = torch.abs(pred_warp - gt_disp)
    d = err_curr - err_warp
    fused = torch.where(d < -1.0, pred_disp,
                        torch.where(d > 1.0, pred_warp,
                                    (pred_disp + pred_warp) / 2.0))
    fused = torch.where(pred_warp <= 0.0, pred_disp, fused)
    return torch.where(gt_disp > 0.0, fused, pred_disp)


def kalman_fusion(pred_disp, pred_warp, P, R: float = 1e-5, Q: float = 1e-5):
    """Per-pixel scalar Kalman blend with outlier rejection.  As in the
    original model the covariance P is never written back after the
    measurement update, so the gain is the constant (P+Q)/(P+Q+R).
    Returns (fused, P)."""
    Pminus = P + Q
    K = Pminus / (Pminus + R)
    fused = pred_warp + K * (pred_disp - pred_warp)
    outlier = torch.abs(pred_warp - pred_disp) > 1.0
    fused = torch.where(pred_warp <= 0.0, pred_disp, fused)
    fused = torch.where(outlier, pred_disp, fused)
    return fused, P
