"""Offline inference over a test dataset: metric tables or saved
disparities (counterpart of ``codd_tpu/apis/inference.py``).

Whole sequences stream through the model; per sequence either the metrics
are evaluated (pushed into a ``RunningStatsWithBuffer``, dumped as CSV and
summarised as ascii tables) or the predicted disparities are saved as
``<name>.disp.pred.npz``.

Unlike ``codd_tpu``, the frame axis is **not** padded to bucket lengths:
nothing is compiled per shape here, so a sequence runs at its own length
(``frame_valid`` is all true).  One process only; merging the rows of
several processes is not implemented.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.codd import CODD
from ..utils.running_stats import RunningStatsWithBuffer
from .evaluation import METER_NAMES, SUM_NAMES, make_sequence_evaluator

__all__ = ["run_inference", "summarize", "GT_KEYS"]

GT_KEYS = ("gt_disp", "gt_flow", "gt_disp_change", "gt_flow_occ", "gt_disp2",
           "gt_disp_occ")


def _to_batch(sample: Dict[str, Any], device) -> Dict[str, Any]:
    """Clip sample (numpy) -> B=1 batch on ``device``; img_hw stays on the
    host."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)
                                )[None].to(device)

    T = sample["imgs"].shape[0]
    batch: Dict[str, Any] = {"l_img": put(sample["imgs"]),
                             "r_img": put(sample["r_imgs"])}
    for k in GT_KEYS:
        if k in sample:
            batch[k] = put(sample[k])
    meta = sample["meta"]
    intr = meta.get("intrinsics") or [1.0, 1.0, 0.0, 0.0]
    batch["intrinsics"] = torch.tensor([intr], dtype=torch.float32,
                                       device=device)
    batch["img_hw"] = tuple(int(v) for v in meta["img_shape"])
    batch["frame_valid"] = torch.ones(T, dtype=torch.bool, device=device)
    return batch


@torch.no_grad()
def _predict_disparities(model: CODD, batch) -> np.ndarray:
    """(T, H, W) fused disparities of one sequence, one transfer."""
    gt_seq = {k: batch[k] for k in GT_KEYS if k in batch}
    outs = model(batch["l_img"], batch["r_img"], batch["intrinsics"],
                 gt_seq=gt_seq)
    return torch.stack([o["pred_disp"][0, ..., 0] for o in outs]).cpu().numpy()


def run_inference(model: CODD, dataset, evaluate: bool = True,
                  show_dir: Optional[str] = None, reciprocal: bool = False,
                  out_csv: Optional[str] = None, metric: str = "default",
                  log=print) -> Dict[str, float]:
    """Evaluate (or dump) every sequence of ``dataset`` on the model's
    device.  Returns the aggregate metric dict of ``summarize``."""
    device = next(model.parameters()).device
    evaluators: Dict[Any, Any] = {}
    stats = RunningStatsWithBuffer(path=out_csv)

    for i in range(len(dataset)):
        sample = dataset[i]
        batch = _to_batch(sample, device)
        name = sample["meta"]["filename"]

        if show_dir:
            h, w = sample["meta"]["img_shape"]
            disp = _predict_disparities(model, batch)[:, :h, :w]
            if reciprocal and sample["meta"].get("calib"):
                disp = sample["meta"]["calib"] / np.maximum(disp, 1e-6)
            out_file = osp.join(show_dir,
                                osp.splitext(name)[0] + ".disp.pred.npz")
            os.makedirs(osp.dirname(out_file), exist_ok=True)
            np.savez_compressed(out_file, disp=disp)
            continue

        if evaluate:
            key = (tuple(sample["meta"]["disp_range"]),
                   tuple(k for k in GT_KEYS if k in batch))
            if key not in evaluators:
                evaluators[key] = make_sequence_evaluator(
                    model, disp_range=key[0],
                    has_disp2="gt_disp2" in batch,
                    has_flow_occ="gt_flow_occ" in batch,
                    has_disp_change="gt_disp_change" in batch,
                    has_disp_occ="gt_disp_occ" in batch)
            metrics = evaluators[key](batch)
            if stats.header is None:
                stats.header = (["filename"] + list(METER_NAMES)
                                + list(SUM_NAMES))
            stats.push(name, [metrics[k] for k in METER_NAMES + SUM_NAMES])

    if show_dir or not evaluate:
        return {}
    if out_csv:
        stats.dump()
    return summarize(stats, metric=metric, log=log)


def _ascii_table(header, row) -> str:
    """One-row summary grid."""
    cells = [str(c) for c in row]
    widths = [max(len(h), len(c)) for h, c in zip(header, cells)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(vals):
        return ("| " + " | ".join(v.ljust(w) for v, w in zip(vals, widths))
                + " |")

    return "\n".join([sep, line(header), sep, line(cells), sep])


def summarize(stats: RunningStatsWithBuffer, metric: str = "default",
              log=print) -> Dict[str, float]:
    """Per-sequence rows -> summary tables, by mode default | disp_only |
    motion_only: disparity metrics average the per-sequence means,
    scene-flow metrics are ratios of sums."""
    allowed = ("default", "disp_only", "motion_only")
    if metric not in allowed:
        raise KeyError(f"metric {metric} is not supported (one of {allowed})")
    rows = np.asarray(list(stats.buffer.values()), np.float64)
    out: Dict[str, float] = {}
    if rows.size == 0:
        return out

    disp_vals = {n: float(rows[:, j].mean())
                 for j, n in enumerate(METER_NAMES)}
    base = len(METER_NAMES)
    count = max(rows[:, base].sum(), 1.0)
    motion_vals = {n: float(rows[:, base + 1 + j].sum() / count)
                   for j, n in enumerate(SUM_NAMES[1:])}

    if metric in ("default", "disp_only"):
        keys = list(METER_NAMES)
        log("Summary:")
        log("\n" + _ascii_table(keys, [round(disp_vals[k], 3) for k in keys]))
        out.update(disp_vals)
    if metric in ("default", "motion_only"):
        keys = [n for n in SUM_NAMES if n != "count"]
        log("Summary:")
        log("\n" + _ascii_table(keys, [round(motion_vals[k], 3) for k in keys]))
        out.update(motion_vals)
        out["count"] = float(rows[:, base].sum())
    return out
