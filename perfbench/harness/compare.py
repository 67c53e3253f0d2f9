"""The numbers that decide ``correct``, each against its limit from
``perfbench/limits/<workload>.json``.

Per checked frame, over the frame's valid (unpadded) pixels of every
stream: the median absolute gap between the program's and the
reference's stereo disparity, fused disparity and motion flow (the
flow's as the length of the gap vector); the share of pixels whose
stereo disparity, fused disparity or handed-on memory disparity lies
more than 1 px from the reference's (``far_share``); and, for every
field of the carry the call hands on (``CARRY``: the previous image, the
memory features, the memory disparity, RAFT-3D's feature and context
maps, the Kalman covariance), the median gap over the reference's median
magnitude, stream by stream (``state_gap``).  Each number is the worst
frame's (and the worst field's and stream's).  The medians stand for the
arithmetic (a lower precision moves every pixel); the far share for the
stereo's tile-hypothesis choices, an argmin over matching costs, which a
near-tie can flip whatever the precision; the carry's gap for a state
handed on stale or wrong, which the next frame's outputs need not show
(the reference runs each checked frame from the carry the program
handed it)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

__all__ = ["percentile", "stream_checks", "stream_values", "FAR_PX", "CARRY"]

FAR_PX = 1.0
# every field of codd_torch's CoddCarry, compared after each checked call
CARRY = ("memory_img", "memory_feat", "memory_disp", "fmap", "netinp", "kalman_p")


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _gap(a: torch.Tensor, b: torch.Tensor, h: int, w: int) -> torch.Tensor:
    a = a.to(b.device).float()[:, :h, :w]
    b = b.float()[:, :h, :w]
    d = a - b
    if d.shape[-1] > 1:
        return torch.linalg.vector_norm(d, dim=-1)
    return d[..., 0].abs()


def _nan_to_inf(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def stream_checks(prog: List[Dict], ref: List[Dict], frame: Sequence[int],
                  limits: Dict) -> Dict[str, Dict]:
    """The numbers of ``stream_values`` that the cell's limits name, each
    with its limit."""
    values = stream_values(prog, ref, frame)
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def _carry_gap(got, want) -> float:
    """The worst stream's median gap of one carry field over the
    reference's median magnitude; 0 where neither side carries it."""
    if got is None or want is None:
        return 0.0 if got is None and want is None else float("inf")
    if got.shape != want.shape:
        return float("inf")
    d = (got.to(want.device).float() - want.float()).abs().flatten(1)
    scale = want.float().abs().flatten(1).median(dim=1).values.clamp(min=1e-30)
    return _nan_to_inf(float((d.median(dim=1).values / scale).max()))


def stream_values(prog: List[Dict], ref: List[Dict], frame: Sequence[int]) -> Dict[str, float]:
    h, w = frame
    worst = {"stereo_p50": 0.0, "fused_p50": 0.0, "flow_p50": 0.0, "far_share": 0.0,
             "state_gap": 0.0}
    if len(prog) != len(ref):
        worst = {k: float("inf") for k in worst}
    for p, r in zip(prog, ref):
        s = _gap(p["stereo"], r["stereo"], h, w)
        far = s > FAR_PX
        worst["stereo_p50"] = max(worst["stereo_p50"], _nan_to_inf(float(s.median())))
        if "flow" in r:
            f = _gap(p["fused"], r["fused"], h, w)
            far = far | (f.to(far.device) > FAR_PX)
            worst["fused_p50"] = max(worst["fused_p50"], _nan_to_inf(float(f.median())))
            fl = _gap(p["flow"], r["flow"], h, w)
            worst["flow_p50"] = max(worst["flow_p50"], _nan_to_inf(float(fl.median())))
        md = _gap(p["state"]["memory_disp"][..., None], r["state"]["memory_disp"][..., None],
                  h, w)
        far = far | (md.to(far.device) > FAR_PX) | ~torch.isfinite(md).to(far.device)
        for k in CARRY:
            worst["state_gap"] = max(worst["state_gap"], _carry_gap(p["state"][k], r["state"][k]))
        bad = ~torch.isfinite(s)
        worst["far_share"] = max(worst["far_share"],
                                 float((far | bad.to(far.device)).float().mean()))
    return worst
