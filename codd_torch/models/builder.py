"""Model factory: config dicts -> CODD estimator on a device, and the
training loss's settings (counterparts of ``codd_tpu/models/builder.py``'s
``build_estimator`` and ``build_loss_config``).  ``model.train_cfg``'s
``freeze_stereo`` / ``freeze_motion`` / ``freeze_fusion`` reach the model
and the loss as there.

The same config file builds in both packages: ``model.motion.type`` is
Motion, GTMotion or absent, ``model.fusion.type`` Fusion, NullFusion,
GTFusion, KalmanFusion or absent, and ``model.runtime`` takes every key
and value ``codd_tpu`` takes.  An unknown key raises ``ValueError`` as
there; an unknown *value* raises too (``codd_tpu`` lets some fall
through).  What each knob does here:

=====================  ====================================================
``gn_impl``            ``auto``/``fused``: kernel 3 (aggregate + solve);
                       ``windowed``/``pallas_window``: kernel 5, then the
                       damped solve in PyTorch; ``dense``: the masked
                       (n, n) form in PyTorch, by this explicit request
                       only: the kernels take every shape.  In training
                       ``auto`` takes kernel 5 and its backward; ``fused``
                       raises (no backward).
``gn_bf16_scores``     kernels 3 and 5 round score and value to bf16
                       before the product; the sum stays f32.  Dropped
                       where ``codd_tpu`` runs its dense form, which keeps
                       f32 scores (``ops/gn.py:resolve_impl``).  Raises
                       in training.
``corr_impl``          ``auto``/``volume``/``volume_reduce``/
                       ``volume_pallas``: bf16 volumes + kernel 2 (the
                       three selects are bit-identical in ``codd_tpu``);
                       ``patch``: kernel 6, no volume.  In training
                       ``auto`` is ``patch`` (kernel 6 and its backward);
                       the volume values raise.
``pixel_center_offset``  passed to both splats.
``tile_warp_variant``  the propagation's warp cost.  ``auto`` / ``exact``
                       / ``pallas``: kernel 1, whose bf16 form ``pallas``
                       computes in f32 and rounds the output while the
                       others follow ``tile_warping`` step by step in bf16
                       (one function in f32); ``pallas`` has no backward.
                       ``tilewin`` / ``grouped``: ``codd_tpu``'s other
                       functions (a fixed column window a tile or tile
                       row, zero outside it), as ATen ops
                       (``ops/tile_warp.py:tile_warp_tilewin``,
                       ``tile_warp_grouped``), trained by autograd.
``init_cost_variant``, ``splat_impl``, ``splat_impl_lr``, ``gn_unroll``
                       formulations of one function for the TPU's
                       compiler.  The port has one kernel per op and runs
                       it whatever the value; the value is validated.
                       The ``xla_window`` splats compute the same function
                       (a fragment past ``points_per_pixel`` saturates the
                       window, and the cap zeroes it anyway;
                       ``tests/test_torch_splat.py``).
``splat_impl_train``   the differentiable splat of joint training
                       (``xla`` or ``xla_sort_window`` in ``codd_tpu``, the
                       same function): the port runs kernel 4 with its
                       backward (``ops/splat.py:SplatComposite``)
                       whatever the value; the value is validated.  The
                       motion stage's splats reach no loss and run kernel
                       4's forward only.
=====================  ====================================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..losses.assembly import LossConfig
from ..ops.corr import CORR_IMPLS
from ..ops.gn import GN_IMPLS
from .codd import CODD

__all__ = ["build_estimator", "build_loss_config", "init_weights",
           "RUNTIME_DEFAULTS", "RUNTIME_VALUES"]

RUNTIME_DEFAULTS = {
    "init_cost_variant": "auto", "tile_warp_variant": "auto",
    "gn_impl": "auto", "gn_bf16_scores": False, "splat_impl": "xla_gather",
    "splat_impl_lr": "", "splat_impl_train": "xla", "corr_impl": "auto",
    "gn_unroll": 1, "pixel_center_offset": 0.0,
}

_SPLAT_IMPLS = ("xla", "xla_gather", "pallas", "xla_window",
                "xla_sort_window")
# every value codd_tpu accepts for the string knobs; the others are typed
RUNTIME_VALUES = {
    "init_cost_variant": ("auto", "unrolled", "map", "phases"),
    "tile_warp_variant": ("auto", "exact", "tilewin", "grouped", "pallas"),
    "gn_impl": GN_IMPLS,
    "corr_impl": CORR_IMPLS,
    "splat_impl": _SPLAT_IMPLS,
    "splat_impl_lr": ("",) + _SPLAT_IMPLS,
    "splat_impl_train": _SPLAT_IMPLS,
}
_MOTION_TYPES = {"Motion": "Motion", "GTMotion": "GTMotion", None: "none"}
_FUSION_TYPES = {"Fusion": "Fusion", "NullFusion": "NullFusion",
                 "GTFusion": "GTFusion", "KalmanFusion": "KalmanFusion",
                 None: "none"}


def _check_runtime(runtime: Dict[str, Any]) -> Dict[str, Any]:
    """Defaults filled in; an unknown key or value raises ValueError."""
    unknown = set(runtime) - set(RUNTIME_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown model.runtime keys: {sorted(unknown)}; "
                         f"known: {sorted(RUNTIME_DEFAULTS)}")
    rt = dict(RUNTIME_DEFAULTS, **runtime)
    for k, allowed in RUNTIME_VALUES.items():
        if rt[k] not in allowed:
            raise ValueError(f"model.runtime.{k}={rt[k]!r}: one of {allowed}")
    if not isinstance(rt["gn_bf16_scores"], (bool, int)):
        raise ValueError("model.runtime.gn_bf16_scores must be a bool, got "
                         f"{rt['gn_bf16_scores']!r}")
    if (isinstance(rt["gn_unroll"], bool) or not isinstance(rt["gn_unroll"], int)
            or rt["gn_unroll"] < 1):
        raise ValueError("model.runtime.gn_unroll must be a positive int, "
                         f"got {rt['gn_unroll']!r}")
    if (isinstance(rt["pixel_center_offset"], bool)
            or not isinstance(rt["pixel_center_offset"], (int, float))):
        raise ValueError("model.runtime.pixel_center_offset must be a "
                         f"number, got {rt['pixel_center_offset']!r}")
    return rt


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
    train_cfg = model_cfg.get("train_cfg") or {}
    rt = _check_runtime(dict(model_cfg.get("runtime") or {}))
    mname = motion.get("type", "Motion") if motion else None
    fname = fusion.get("type", "Fusion") if fusion else None
    if mname not in _MOTION_TYPES or fname not in _FUSION_TYPES:
        raise ValueError(f"motion type {mname!r} / fusion type {fname!r}: "
                         f"one of {sorted(k for k in _MOTION_TYPES if k)} / "
                         f"{sorted(k for k in _FUSION_TYPES if k)} or absent")
    max_disp = (stereo.get("initialization", {}).get("max_disp")
                or stereo.get("max_disp") or 320)
    model = CODD(
        max_disp=int(max_disp),
        iters=int(motion.get("iters", 16)) if motion else 16,
        fusion_channel=int(fusion.get("fusion_channel", 32)) if fusion else 32,
        stereo_feat_channels=int(fusion.get("in_channels", 24)) if fusion
        else 24,
        motion_type=_MOTION_TYPES[mname], fusion_type=_FUSION_TYPES[fname],
        gn_impl=rt["gn_impl"], gn_bf16_scores=bool(rt["gn_bf16_scores"]),
        corr_impl=rt["corr_impl"],
        pixel_center_offset=float(rt["pixel_center_offset"]),
        tile_warp_variant=rt["tile_warp_variant"],
        freeze_stereo=bool(train_cfg.get("freeze_stereo", False)),
        freeze_motion=bool(train_cfg.get("freeze_motion", False)),
        freeze_fusion=bool(train_cfg.get("freeze_fusion", False)))
    if seed is not None:
        init_weights(model, seed)
    # full-f32 convolutions and products: TF32 breaks the GN logits' norm
    # cancellation (process-wide switches)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(dev).eval()


def build_loss_config(model_cfg: Dict[str, Any],
                      disp_range=(1.0, 210.0)) -> LossConfig:
    """The loss settings of a model config: each stage's loss is on where
    the stage exists as a network and is not frozen."""
    stereo = model_cfg.get("stereo") or {}
    motion = model_cfg.get("motion")
    fusion = model_cfg.get("fusion")
    train_cfg = model_cfg.get("train_cfg") or {}
    sloss = stereo.get("loss") or {}
    mloss = (motion or {}).get("loss") or {}
    floss = (fusion or {}).get("loss") or {}
    max_disp = (stereo.get("initialization", {}).get("max_disp")
                or stereo.get("max_disp") or 320)
    return LossConfig(
        max_disp=int(max_disp),
        disp_range=tuple(disp_range),
        stereo=not train_cfg.get("freeze_stereo", False),
        motion=(motion is not None and motion.get("type") == "Motion"
                and not train_cfg.get("freeze_motion", False)),
        fusion=(fusion is not None and fusion.get("type") == "Fusion"
                and not train_cfg.get("freeze_fusion", False)),
        motion_loss_weight=float(mloss.get("loss_weight", 1.0)),
        fusion_loss_weight=float(floss.get("loss_weight", 1.0)),
        wr_weight=float(floss.get("wr_weight", 1.0)),
        wf_weight=float(floss.get("wf_weight", 1.0)),
        alpha=float(sloss.get("alpha", 0.9)),
        c=float(sloss.get("c", 0.1)),
    )
