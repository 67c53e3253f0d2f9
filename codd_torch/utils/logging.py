"""Structured training logs: jsonl always, TensorBoard when available (the
port's own copy of ``codd_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["MetricLogger", "get_logger"]


def get_logger(name: str = "codd_torch", log_file: Optional[str] = None,
               level=logging.INFO) -> logging.Logger:
    """File + console logger."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Appends scalar dicts to metrics.jsonl and (if importable) streams
    them to TensorBoard under ``work_dir/tb``."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self._jsonl = open(os.path.join(work_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
        except Exception:
            self._tb = None

    def log(self, step: int, metrics: Dict[str, Any]):
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
