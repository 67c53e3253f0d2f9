"""The reference CODD (``perfbench/reference``, plain PyTorch) built from a
configuration's ``model`` dict, as the port's ``build_estimator`` reads
it; TF32 off for its convolutions and products, as the configuration
states."""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.models.codd import CODD

__all__ = ["reference_model"]


def reference_model(model_cfg: Dict) -> CODD:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stereo = model_cfg.get("stereo") or {}
    motion = model_cfg["motion"]
    fusion = model_cfg["fusion"]
    return CODD(max_disp=int(stereo["initialization"]["max_disp"]),
                iters=int(motion["iters"]),
                fusion_channel=int(fusion["fusion_channel"]),
                stereo_feat_channels=int(fusion["in_channels"]))
