"""Whole-sequence streaming evaluation with on-device metric accumulation
(counterpart of ``codd_tpu/apis/evaluation.py``).

A Python loop over the frames takes the place of ``lax.scan``.  What is
kept is what matters on a GPU too: every meter is a (sum, count) pair of
0-d tensors on the model's device, no value is read back per frame, and a
sequence ends in **one** transfer of all its metrics.  Frames whose
``frame_valid`` is false and pixels outside ``img_hw`` are weighted out,
so the same padded batch gives the same numbers as the JAX evaluator.

Metric names:
  epe, th3                                 disparity
  tepe, th3_tepe, tepe_rel, th1_tepe_rel   temporal (flow-aligned)
  flow_mag                                 mean ground-truth flow magnitude
  count, epe2d_scene_flow, epe2d_optical_flow, 1px_scene_flow,
  1px_optical_flow                         SE(3)-induced scene-flow sums
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.codd import CODD
from ..ops.metrics import masked_mean
from ..ops.projective import induced_flow
from ..ops.warp import flow_warp, meshgrid_xy
from ..utils.masks import (BF_DEFAULT, compute_gt_disp_change,
                           compute_valid_mask)

__all__ = ["METER_NAMES", "SUM_NAMES", "make_sequence_evaluator"]

METER_NAMES = ("epe", "th3", "tepe", "th3_tepe", "tepe_rel", "th1_tepe_rel",
               "flow_mag")
SUM_NAMES = ("count", "epe2d_scene_flow", "epe2d_optical_flow",
             "1px_scene_flow", "1px_optical_flow")
# ground truth the oracle variants read from step(gt=...)
_ORACLE_KEYS = ("gt_disp", "gt_flow", "gt_disp_change", "gt_flow_occ")


def make_sequence_evaluator(model: CODD,
                            disp_range: Tuple[float, float] = (1.0, 210.0),
                            has_disp2: bool = False,
                            has_flow_occ: bool = False,
                            has_disp_change: bool = False,
                            has_disp_occ: bool = False):
    """Returns ``fn(batch) -> {name: float}`` over one padded sequence.

    ``batch`` holds, on the model's device, l_img / r_img (1,T,H,W,3),
    intrinsics (1,4), frame_valid (T,) bool and whichever gt_* (1,T,H,W,C)
    the dataset provides; img_hw is the pre-pad (height, width) as two host
    integers.  B must be 1 (streaming, as at test time)."""
    needs_gt = (model.motion_type == "GTMotion"
                or model.fusion_type == "GTFusion")

    @torch.no_grad()
    def evaluate(batch) -> Dict[str, float]:
        l_seq, r_seq = batch["l_img"], batch["r_img"]
        intr = batch["intrinsics"]
        B, T, H, W, _ = l_seq.shape
        dev = l_seq.device
        img_h, img_w = int(batch["img_hw"][0]), int(batch["img_hw"][1])
        frame_valid = batch["frame_valid"]
        x, y = meshgrid_xy(H, W, device=dev)
        crop = ((x < img_w) & (y < img_h))[None, ..., None]

        gt_disp_seq = batch["gt_disp"]
        gt_flow_seq = batch.get("gt_flow")
        gt_disp2_seq = batch.get("gt_disp2") if has_disp2 else None
        gt_occ_seq = batch.get("gt_flow_occ") if has_flow_occ else None
        gt_change_seq = (batch.get("gt_disp_change") if has_disp_change
                         else None)
        gt_disp_occ_seq = batch.get("gt_disp_occ") if has_disp_occ else None

        zero = torch.zeros((), device=dev)
        meters = {k: [zero, zero] for k in METER_NAMES}
        sums = {k: zero for k in SUM_NAMES}

        def update(name, value, has_valid):
            w = has_valid.to(value.dtype)
            meters[name] = [meters[name][0] + value * w, meters[name][1] + w]

        def seg_occ_at(t):
            if gt_disp_occ_seq is None:
                return None
            # <= 0 means non-occluded, hence valid
            return (gt_disp_occ_seq[:, t] <= 0).float()

        def disp_metrics(pred, gt_disp, seg_occ, fvalid):
            mask = compute_valid_mask(gt_disp, disp_range, seg_occ) & crop
            has = mask.any() & fvalid
            err = torch.abs(pred - gt_disp)
            update("epe", masked_mean(err, mask), has)
            update("th3", masked_mean((err > 3.0).float(), mask), has)
            return mask

        carry, out = model.first_step(l_seq[:, 0], r_seq[:, 0], intr)
        pred_prev = out["pred_disp"]
        mask_prev = disp_metrics(pred_prev, gt_disp_seq[:, 0], seg_occ_at(0),
                                 torch.ones((), dtype=torch.bool, device=dev))

        for t in range(1, T):
            gt = ({k: batch[k][:, t] for k in _ORACLE_KEYS if k in batch}
                  if needs_gt else None)
            carry, out = model.step(carry, l_seq[:, t], r_seq[:, t], intr,
                                    gt=gt)
            pred = out["pred_disp"]
            gt_disp = gt_disp_seq[:, t]
            gt_disp_prev = gt_disp_seq[:, t - 1]
            fvalid = frame_valid[t]
            seg_occ = seg_occ_at(t)
            mask_disp = disp_metrics(pred, gt_disp, seg_occ, fvalid)

            if gt_flow_seq is not None:
                flow = gt_flow_seq[:, t - 1]
                # KITTI: ground-truth disparity may exist in one frame
                # only; a dummy mid-range value stands in for the mask
                any_gt = (gt_disp > 0).any()
                gt_for_mask = torch.where(
                    any_gt, gt_disp, torch.full_like(gt_disp, BF_DEFAULT / 2.0))
                mask = compute_valid_mask(gt_for_mask, disp_range, seg_occ,
                                          gt_flow_prev=flow) & crop
                to_warp = torch.cat([gt_disp, pred, mask.to(pred.dtype)], -1)
                warped, valid_w = flow_warp(to_warp, flow,
                                            padding_mode="zeros",
                                            mode="nearest")
                warped_gt = warped[..., 0:1]
                warped_pred = warped[..., 1:2]
                mask_curr = valid_w[..., 0:1] & (warped[..., 2:3] > 0.5) & mask
                if gt_disp2_seq is not None:
                    warped_gt = gt_disp2_seq[:, t - 1]
                    mask_curr = mask_curr & (warped_gt > 0.0)

                joint = mask_prev & mask_curr
                has = mask_prev.any() & mask_curr.any() & fvalid
                abs_err = torch.abs((warped_pred - pred_prev)
                                    - (warped_gt - gt_disp_prev))
                rel_err = abs_err / (torch.abs(warped_gt - gt_disp_prev)
                                     + 1e-3)
                update("tepe", masked_mean(abs_err, joint), has)
                update("tepe_rel", masked_mean(rel_err, joint), has)
                update("th1_tepe_rel",
                       masked_mean((rel_err > 1.0).float(), joint), has)
                update("th3_tepe",
                       masked_mean((abs_err > 3.0).float(), joint), has)
                update("flow_mag",
                       torch.mean(torch.sqrt(torch.sum(flow ** 2, -1))),
                       fvalid)

                # SE(3)-induced scene-flow sums
                if "Ts" in out and (has_flow_occ or has_disp_change
                                    or has_disp2):
                    occ_excl = None
                    if gt_change_seq is not None:
                        change = gt_change_seq[:, t - 1]
                    elif gt_occ_seq is not None:
                        occ_excl = gt_occ_seq[:, t - 1] > 0
                        change, _ = compute_gt_disp_change(
                            occ_excl, gt_disp_prev, gt_disp, flow)
                    else:
                        disp2 = gt_disp2_seq[:, t - 1]
                        fill = torch.full_like(disp2, BF_DEFAULT)
                        change = torch.where(disp2 <= 0.0, fill,
                                             disp2 - gt_disp_prev)
                        change = torch.where(gt_disp_prev <= 0.0, fill, change)
                    m3 = compute_valid_mask(gt_disp_prev, disp_range, seg_occ,
                                            gt_flow_prev=flow,
                                            gt_disp_change=change) & crop
                    if occ_excl is not None:
                        m3 = m3 & ~occ_excl
                    depth1 = (BF_DEFAULT / pred_prev[..., 0].clamp(min=1e-5)
                              ).clamp(0.0, BF_DEFAULT)
                    est, _, _ = induced_flow(out["Ts"], depth1, intr)
                    est = torch.cat([est[..., :-1],
                                     est[..., -1:] * BF_DEFAULT], -1)
                    err = est - torch.cat([flow, change], -1)
                    epe_sf = torch.sqrt(torch.sum(err ** 2, -1, keepdim=True))
                    epe_of = torch.sqrt(torch.sum(err[..., :2] ** 2, -1,
                                                  keepdim=True))
                    m3f = (m3 & fvalid & m3.any()).float()
                    sums["count"] = sums["count"] + m3f.sum()
                    sums["epe2d_scene_flow"] = (sums["epe2d_scene_flow"]
                                                + (epe_sf * m3f).sum())
                    sums["epe2d_optical_flow"] = (sums["epe2d_optical_flow"]
                                                  + (epe_of * m3f).sum())
                    sums["1px_scene_flow"] = (
                        sums["1px_scene_flow"] + ((epe_sf < 1.0) * m3f).sum())
                    sums["1px_optical_flow"] = (
                        sums["1px_optical_flow"] + ((epe_of < 1.0) * m3f).sum())

            pred_prev, mask_prev = pred, mask_disp

        # the sequence's one transfer
        flat = torch.stack(
            [meters[k][0] / meters[k][1].clamp(min=1.0) for k in METER_NAMES]
            + [sums[k] for k in SUM_NAMES]).tolist()
        return dict(zip(METER_NAMES + SUM_NAMES, flat))

    return evaluate
