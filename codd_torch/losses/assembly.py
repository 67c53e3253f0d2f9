"""The loss of a T-frame training clip from the per-frame model outputs
and the ground truth (counterpart of ``codd_tpu/losses/assembly.py``).
Keys that start with "loss" are the terms summed into the total; the
others are logged metrics.  Every term and metric is a sum over a
gradient-free count (HITNet's (sum, count) pairs, ``masked_mean``,
``global_mean``; no root or product of means), so under a process group
each process's loss is its rows' share of the global batch's
(``parallel.mesh.counting``)."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..ops.metrics import masked_mean, thres_metric
from ..utils.masks import BF_DEFAULT, compute_gt_disp_change, compute_valid_mask
from .hitnet import HITLossConfig, hit_loss
from .temporal import fusion_loss, motion_loss

__all__ = ["LossConfig", "codd_train_loss"]


class LossConfig:
    def __init__(
        self,
        max_disp: int = 320,
        disp_range: Tuple[float, float] = (1.0, 210.0),
        stereo: bool = True,
        motion: bool = True,
        fusion: bool = True,
        motion_loss_weight: float = 1.0,
        fusion_loss_weight: float = 1.0,
        wr_weight: float = 1.0,
        wf_weight: float = 1.0,
        alpha: float = 0.9,
        c: float = 0.1,
    ):
        self.hit = HITLossConfig(max_disp=max_disp, alpha=alpha, c=c)
        self.max_disp = max_disp
        self.disp_range = disp_range
        self.stereo = stereo
        self.motion = motion
        self.fusion = fusion
        self.motion_loss_weight = motion_loss_weight
        self.fusion_loss_weight = fusion_loss_weight
        self.wr_weight = wr_weight
        self.wf_weight = wf_weight


def _gt_disp_change_for_frame(batch: Dict[str, torch.Tensor], idx: int):
    """Disparity change from frame ``idx`` to ``idx + 1``: given, else from
    the flow and occlusion, else from ``gt_disp2``."""
    if batch.get("gt_disp_change") is not None:
        return batch["gt_disp_change"][:, idx]
    if batch.get("gt_flow_occ") is not None:
        change, _ = compute_gt_disp_change(
            batch["gt_flow_occ"][:, idx] > 0, batch["gt_disp"][:, idx],
            batch["gt_disp"][:, idx + 1], batch["gt_flow"][:, idx])
        return change
    if batch.get("gt_disp2") is not None:
        disp2 = batch["gt_disp2"][:, idx]
        disp_prev = batch["gt_disp"][:, idx]
        fill = torch.full_like(disp2, BF_DEFAULT)
        change = torch.where(disp2 <= 0.0, fill, disp2 - disp_prev)
        return torch.where(disp_prev <= 0.0, fill, change)
    raise ValueError("No disparity-change supervision available "
                     "(need gt_disp_change, gt_flow_occ or gt_disp2)")


def codd_train_loss(cfg: LossConfig, outs: List[Dict[str, Any]],
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the log dict of a clip: ``outs`` from
    ``CODD(..., train=True)``, ``batch`` with (B,T,H,W,C) ground truth."""
    logs: Dict[str, torch.Tensor] = {}
    total = 0.0
    seg = batch.get("gt_semantic_seg")

    for idx, out in enumerate(outs):
        gt_disp = batch["gt_disp"][:, idx]
        seg_i = seg[:, idx] if seg is not None else None
        mask_disp = compute_valid_mask(gt_disp, cfg.disp_range, seg_i)

        if cfg.stereo:
            l, hl = hit_loss(
                cfg.hit, out["init_cv_pyramid"], out["prop_disp_pyramid"],
                out["dx_pyramid"], out["dy_pyramid"], out["w_pyramid"],
                gt_disp, seg_i)
            total = total + l
            logs[f"loss_disp{idx}"] = l
            for k, v in hl.items():
                logs[f"{k}{idx}"] = v

        pred = out["pred_disp"]
        logs[f"epe{idx}"] = masked_mean(torch.abs(gt_disp - pred), mask_disp)
        logs[f"thres3{idx}"] = thres_metric(pred, gt_disp, mask_disp, 3.0)

        if idx >= 1:
            prev = idx - 1
            if cfg.motion and "flow2d_est" in out:
                gt_flow = batch["gt_flow"][:, prev]
                change = _gt_disp_change_for_frame(batch, prev)
                gt_disp_prev = batch["gt_disp"][:, prev]
                seg_p = seg[:, prev] if seg is not None else None
                m = compute_valid_mask(gt_disp_prev, cfg.disp_range, seg_p)
                m = m & compute_valid_mask(gt_disp_prev, cfg.disp_range,
                                           gt_flow_prev=gt_flow,
                                           gt_disp_change=change)
                flowxyz = torch.cat([gt_flow, change / BF_DEFAULT], -1)
                ml, mlogs = motion_loss(
                    out["flow2d_est"], out["flow2d_rev"], flowxyz, m,
                    loss_weight=cfg.motion_loss_weight)
                total = total + ml
                logs[f"loss_warp{idx}"] = ml
                for k, v in mlogs.items():
                    logs[f"{k}{idx}"] = v

            if cfg.fusion and "fusion_weights" in out:
                fl = fusion_loss(
                    out["pred_disp"], gt_disp,
                    out["fusion_weights"], out["reset_weights"],
                    out["pred_curr"], out["pred_warp"],
                    loss_weight=cfg.fusion_loss_weight,
                    wr_weight=cfg.wr_weight, wf_weight=cfg.wf_weight,
                    min_disp=1.0, max_disp=float(cfg.max_disp))
                total = total + fl
                logs[f"loss_temporal{idx}"] = fl

    logs["loss"] = total
    return total, logs
