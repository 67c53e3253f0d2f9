"""Model factory: config dicts -> CODD estimator on a device (counterpart
of ``codd_tpu/models/builder.py:build_estimator``).

This package implements the streaming eval path at the default runtime
knobs only.  Unknown ``runtime`` keys raise ``ValueError`` as in
``codd_tpu``; known keys set to anything but the default, and motion or
fusion types other than ``Motion``/``Fusion``, raise
``NotImplementedError`` rather than run a different path silently.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .codd import CODD

__all__ = ["build_estimator", "init_weights", "RUNTIME_DEFAULTS"]

# the codd_tpu runtime knobs and the only values this package implements
RUNTIME_DEFAULTS = {
    "init_cost_variant": "auto", "tile_warp_variant": "auto",
    "gn_impl": "auto", "gn_bf16_scores": False, "splat_impl": "xla_gather",
    "splat_impl_lr": "", "splat_impl_train": "xla", "corr_impl": "auto",
    "gn_unroll": 1, "pixel_center_offset": 0.0,
}


def _resolve_device(device) -> torch.device:
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_estimator: CUDA is not available; pass "
                           "device='cpu' to run the plain PyTorch path")
    return device


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """Seeded random weights: lecun-normal conv kernels, zero biases; the
    frozen norms keep identity statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            w = getattr(m, "weight", None)
            if not isinstance(w, torch.nn.Parameter) or w.ndim != 4:
                continue
            # fan-in of (O,I,kh,kw) conv and (I,O,kh,kw) transposed weights
            fan_in = (w.shape[0] if isinstance(m, torch.nn.ConvTranspose2d)
                      else w.shape[1]) * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


def build_estimator(model_cfg: Dict[str, Any], device=None,
                    seed: Optional[int] = 0) -> CODD:
    """CODD on ``device`` ("cuda" by default; raises without CUDA unless
    ``device="cpu"``), in eval mode, with seeded random weights (load a
    state dict afterwards to replace them)."""
    dev = _resolve_device(device)
    stereo = model_cfg.get("stereo") or {}
    motion = model_cfg.get("motion")
    fusion = model_cfg.get("fusion")
    runtime = dict(model_cfg.get("runtime") or {})
    unknown = set(runtime) - set(RUNTIME_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown model.runtime keys: {sorted(unknown)}; "
                         f"known: {sorted(RUNTIME_DEFAULTS)}")
    for k, v in runtime.items():
        if v != RUNTIME_DEFAULTS[k]:
            raise NotImplementedError(
                f"model.runtime.{k}={v!r}: codd_torch implements only "
                f"{k}={RUNTIME_DEFAULTS[k]!r}")
    mtype = motion.get("type", "Motion") if motion else None
    ftype = fusion.get("type", "Fusion") if fusion else None
    if mtype != "Motion" or ftype != "Fusion":
        raise NotImplementedError(
            f"motion type {mtype!r} / fusion type {ftype!r}: codd_torch "
            "implements Motion + Fusion only")
    max_disp = (stereo.get("initialization", {}).get("max_disp")
                or stereo.get("max_disp") or 320)
    model = CODD(max_disp=int(max_disp), iters=int(motion.get("iters", 16)),
                 fusion_channel=int(fusion.get("fusion_channel", 32)),
                 stereo_feat_channels=int(fusion.get("in_channels", 24)))
    if seed is not None:
        init_weights(model, seed)
    # full-f32 convolutions and products: TF32 breaks the GN logits' norm
    # cancellation (process-wide switches)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(dev).eval()
