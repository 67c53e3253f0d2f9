"""HITNet losses: initialisation, propagation, slant and confidence terms
(counterpart of ``codd_tpu/losses/hitnet.py``).

As there, each term is accumulated as (weighted sum, count) pairs over
the pyramid levels and divided once, an empty mask contributes 0, and the
9x9 plane-fit kernels that give the ground-truth slants are constants.
Tensors are NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.metrics import masked_mean
from ..utils.precision import absolute

__all__ = ["HITLossConfig", "hit_loss", "hit_loss_with_depth",
           "plane_fit_kernels", "echo_loss", "PROP_WEIGHTS", "TRUNCATION_A",
           "W_WEIGHTS"]


def plane_fit_kernels() -> Tuple[np.ndarray, np.ndarray]:
    """9x9 least-squares plane-fit kernels (kx, ky): a disparity map
    convolved with them gives its fitted x and y slopes."""
    A = np.zeros((81, 3))
    for i in range(81):
        A[i, 0] = i // 9 - 4
        A[i, 1] = i % 9 - 4
        A[i, 2] = 1
    B = np.linalg.inv(A.T @ A) @ A.T
    ky = B[0].reshape(9, 9)  # row-coordinate coefficient -> d/dy
    kx = B[1].reshape(9, 9)  # col-coordinate coefficient -> d/dx
    return kx.astype(np.float32), ky.astype(np.float32)


_KX, _KY = plane_fit_kernels()


def _conv9x9(x, kernel: np.ndarray):
    """x (B,H,W,1); 9x9 same-padding cross-correlation with a constant."""
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)[None, None]
    return F.conv2d(x.permute(0, 3, 1, 2), k, padding=4).permute(0, 2, 3, 1)


def echo_loss(x, alpha, c):
    """General adaptive robust loss (Barron, arXiv 1701.03077)."""
    a = abs(alpha - 2.0)
    return (a / alpha) * (((x / c) ** 2 / a + 1.0) ** (alpha / 2.0) - 1.0)


def _subpix_cost(cost, disp, maxdisp):
    """The cost volume (B,h,w,D) linearly interpolated at the sub-pixel
    disparity disp (B,h,w,1)."""
    disp = torch.clamp(disp, 0.0, maxdisp - 2.0)
    d0 = torch.floor(disp)
    idx0 = d0.long()
    idx0 = torch.where(idx0 < 0, idx0 + cost.shape[-1], idx0)  # as JAX
    c0 = torch.gather(cost, -1, idx0)
    c1 = torch.gather(cost, -1, idx0 + 1)
    return (disp - d0) * c1 + (d0 + 1.0 - disp) * c0


def _non_match_cost(cost, d_gt):
    """Least cost outside the +-1.5 px band around d_gt (inf if none)."""
    D = cost.shape[-1]
    cand = torch.arange(D, dtype=d_gt.dtype, device=d_gt.device)
    far = (cand < d_gt - 1.5) | (cand > d_gt + 1.5)
    masked = torch.where(far, cost, torch.full_like(cost, float("inf")))
    # amin splits the gradient among ties, as jnp.min does
    return torch.amin(masked, -1, keepdim=True)


class HITLossConfig:
    def __init__(self, max_disp=320, lambda_init=1.0, lambda_prop=1.0,
                 lambda_slant=1.0, lambda_w=1.0, alpha=0.9, c=0.1):
        self.max_disp = max_disp
        self.lambda_init = lambda_init
        self.lambda_prop = lambda_prop
        self.lambda_slant = lambda_slant
        self.lambda_w = lambda_w
        self.alpha = alpha
        self.c = c


PROP_WEIGHTS = [1 / 64, 1 / 32, 1 / 32, 1 / 16, 1 / 16, 1 / 8, 1 / 8,
                1 / 4, 1 / 4, 1 / 4, 1 / 2, 1.0]
TRUNCATION_A = [1.0] * 9 + [10000.0] * 3
W_WEIGHTS = [1 / 32, 1 / 32, 1 / 16, 1 / 16, 1 / 8, 1 / 8, 1 / 4, 1 / 4]


def _maxpool(x, k):
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def _acc(v, m):
    m = m.to(v.dtype)
    return torch.sum(v * m), torch.sum(m)


def hit_loss(
    cfg: HITLossConfig,
    init_cv_pyramid: List[torch.Tensor],    # coarse -> fine, (B,h,w,D)
    prop_disp_pyramid: List[torch.Tensor],  # 12 x (B,H,W,1)
    dx_pyramid: List[torch.Tensor],
    dy_pyramid: List[torch.Tensor],
    w_pyramid: List[torch.Tensor],          # 8 x (B,H,W,1)
    d_gt,                                   # (B,H,W,1)
    seg_gt=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if seg_gt is not None:
        d_gt = torch.where(seg_gt == 0, torch.zeros_like(d_gt), d_gt)
    dx_gt = _conv9x9(d_gt, _KX)
    dy_gt = _conv9x9(d_gt, _KY)

    L = len(init_cv_pyramid)
    # ground-truth pyramid: maxpool by 4 * 2^i, / 2^i; coarse first
    gt_pyr = [_maxpool(d_gt, 4 * 2 ** i) / 2 ** i for i in range(L)][::-1]

    init_sum = init_cnt = 0.0
    for i, cv in enumerate(init_cv_pyramid):
        level_maxd = cfg.max_disp / (2 ** (L - 1 - i))
        gt = gt_pyr[i]
        mask = (gt > 0) & (gt < level_maxd)
        cost_gt = _subpix_cost(cv, gt, level_maxd)
        cost_nm = _non_match_cost(cv, gt)
        val = cfg.lambda_init * (cost_gt + F.relu(1.0 - cost_nm))
        s, c = _acc(val, mask)
        init_sum, init_cnt = init_sum + s, init_cnt + c

    mask = (d_gt > 0) & (d_gt < cfg.max_disp)
    prop_sum = prop_cnt = 0.0
    diffs = []
    for i, disp in enumerate(prop_disp_pyramid):
        diff = absolute(d_gt - disp)
        diffs.append(diff)
        val = cfg.lambda_prop * PROP_WEIGHTS[i] * echo_loss(
            torch.clamp(diff, max=TRUNCATION_A[i]), cfg.alpha, cfg.c)
        s, c = _acc(val, mask)
        prop_sum, prop_cnt = prop_sum + s, prop_cnt + c

    slant_sum = slant_cnt = 0.0
    for i in range(len(dx_pyramid)):
        m = mask & (diffs[i] < 1.0)
        val = cfg.lambda_slant * PROP_WEIGHTS[i] * (
            absolute(dx_gt - dx_pyramid[i]) + absolute(dy_gt - dy_pyramid[i]))
        s, c = _acc(val, m)
        slant_sum, slant_cnt = slant_sum + s, slant_cnt + c

    C1, C2 = 1.0, 1.5
    w_sum = w_cnt = 0.0
    for i, w in enumerate(w_pyramid):
        diff = diffs[i + 1]  # no confidence at the first pyramid level
        closer = diff < C1
        further = diff > C2
        m = mask & (closer | further)
        val = cfg.lambda_w * W_WEIGHTS[i] * (
            F.relu(1.0 - w) * closer.to(w.dtype)
            + F.relu(w) * further.to(w.dtype))
        s, c = _acc(val, m)
        w_sum, w_cnt = w_sum + s, w_cnt + c

    def per(s, c):
        return s / torch.clamp(torch.as_tensor(c), min=1.0)

    total = per(init_sum + prop_sum + slant_sum + w_sum,
                init_cnt + prop_cnt + slant_cnt + w_cnt)
    logs = {"init_loss": per(init_sum, init_cnt),
            "prop_loss": per(prop_sum, prop_cnt),
            "slant_loss": per(slant_sum, slant_cnt),
            "w_loss": per(w_sum, w_cnt)}
    return total, logs


def hit_loss_with_depth(
    cfg: HITLossConfig,
    init_cv_pyramid, prop_disp_pyramid, dx_pyramid, dy_pyramid, w_pyramid,
    d_gt, seg_gt=None,
    calib: float = 1.0, eps: float = 1e-8,
    lambda_depth: float = 1.0, lambda_depth_grad: float = 1.0,
    lambda_depth_normal: float = 1.0,
):
    """``hit_loss`` plus log-depth, depth-gradient and surface-normal
    terms."""
    total, logs = hit_loss(cfg, init_cv_pyramid, prop_disp_pyramid,
                           dx_pyramid, dy_pyramid, w_pyramid, d_gt, seg_gt)
    logs = dict(logs)
    logs["hitnet_loss"] = total

    pred_depth = calib / (prop_disp_pyramid[-1] + eps)
    target_depth = calib / (d_gt + eps)
    mask = (d_gt > 0) & (d_gt < cfg.max_disp)

    def comp_err(a, b):
        return torch.log1p(absolute(a - b))

    depth_loss = lambda_depth * masked_mean(comp_err(pred_depth, target_depth),
                                            mask)
    logs["depth_loss"] = depth_loss
    total = total + depth_loss

    if lambda_depth_grad > 0 or lambda_depth_normal > 0:
        pm = pred_depth * mask
        tm = target_depth * mask
        pdx, pdy = _conv9x9(pm, _KX), _conv9x9(pm, _KY)
        tdx, tdy = _conv9x9(tm, _KX), _conv9x9(tm, _KY)
        grad_loss = (masked_mean(comp_err(pdx, tdx), mask)
                     + masked_mean(comp_err(pdy, tdy), mask))
        pn = torch.cat([-pdx, -pdy, torch.ones_like(pdx)], -1)
        tn = torch.cat([-tdx, -tdy, torch.ones_like(tdx)], -1)
        cos = torch.sum(pn * tn, -1, keepdim=True) / (
            torch.linalg.norm(pn, dim=-1, keepdim=True)
            * torch.linalg.norm(tn, dim=-1, keepdim=True) + eps)
        normal_loss = masked_mean(absolute(1.0 - cos), mask)
        logs["depth_grad_loss"] = lambda_depth_grad * grad_loss
        logs["depth_normal_loss"] = lambda_depth_normal * normal_loss
        total = total + logs["depth_grad_loss"] + logs["depth_normal_loss"]

    return total, logs
