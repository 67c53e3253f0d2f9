"""Python-file config system with ``_base_`` composition and dot-path
overrides.

Mirrors the reference's mmcv Config workflow (reference:
configs/training_config.py:3-6, train.py:55,76-77): configs are python
files that define top-level variables; ``_base_`` lists parent config
files merged depth-first (child wins, dicts merge recursively); CLI
``--options a.b.c=v`` applies deep overrides.

The model config keeps the reference's swap-ability contract
(README.md:66-87): ``model.motion.type`` / ``model.fusion.type`` accept the
reference registry names (Motion, GTMotion, Fusion, NullFusion, GTFusion,
KalmanFusion) or may be omitted entirely.
"""

from __future__ import annotations

import ast
import copy
import os.path as osp
import runpy
from typing import Any, Dict, List, Optional

__all__ = ["load_config", "merge_dict", "apply_options", "Config"]


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Recursive merge; override wins; dicts merge, everything else replaces."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_file(path: str) -> Dict[str, Any]:
    ns = runpy.run_path(path)
    cfg = {k: v for k, v in ns.items()
           if not k.startswith("_") and not callable(v)
           and not isinstance(v, type(osp))}
    bases = ns.get("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = b if osp.isabs(b) else osp.join(osp.dirname(path), b)
        merged = merge_dict(merged, _load_file(bpath))
    return merge_dict(merged, cfg)


def apply_options(cfg: Dict, options: Optional[List[str]]) -> Dict:
    """Apply ``a.b.c=value`` overrides (values parsed as python literals
    when possible, else kept as strings)."""
    if not options:
        return cfg
    for opt in options:
        key, _, raw = opt.partition("=")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return cfg


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v


def load_config(path: str, options: Optional[List[str]] = None) -> Config:
    cfg = _load_file(osp.abspath(path))
    cfg = apply_options(cfg, options)
    return Config(cfg)
