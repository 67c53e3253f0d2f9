"""Mixed-precision helpers (counterpart of ``codd_tpu/utils/precision.py``).

``codd_tpu`` has two bf16 modes, and the port keeps both:

* the speed benchmark (``tools/bench.py --bf16``) casts the parameters
  and the frames to bf16 (``cast_floats`` on the model and the inputs);
  compute follows, except where the model pins f32 (the SE(3) manifold
  math, the GN system and solve, the splat, the correlation products);
* the inference CLI (``tools/inference.py --bf16``) casts the parameters
  only and feeds f32 frames.  flax promotes a bf16 kernel against an f32
  input to f32, so that mode computes in f32 with weights rounded to
  bf16: ``round_floats``.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["cast_floats", "round_floats", "rdiv"]


def cast_floats(obj: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Cast every floating-point tensor of ``obj`` to ``dtype``.

    ``obj`` is a tensor, a dict / list / tuple of them (nested), or an
    ``nn.Module``, whose floating parameters and buffers are cast in place
    (the module is returned).  Integer and bool tensors, and anything
    else, pass unchanged."""
    if isinstance(obj, torch.nn.Module):
        return obj.to(dtype)
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: cast_floats(v, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_floats(v, dtype) for v in obj)
    return obj


def round_floats(module: torch.nn.Module,
                 dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """Round ``module``'s floating parameters and buffers to ``dtype`` and
    keep their own dtype (in place; returns the module)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(dtype))
    return module


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x``; below f32 as JAX computes it, ``c`` in x's dtype and one
    true division.  PyTorch's ``c / x`` is ``x.reciprocal() * c``, which
    rounds twice: in bf16 that moves a tenth of the depths ``210 / disp``
    by an ulp.  In f32 the two differ by an f32 ulp, and the port keeps
    PyTorch's form, on whose bits the record of ``chip_smoke.py`` phase 6
    (kernel run against plain run, a near-tie) rests."""
    if x.dtype in (torch.float32, torch.float64):
        return c / x
    return torch.full_like(x, c) / x
