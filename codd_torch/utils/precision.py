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

__all__ = ["absolute", "cast_floats", "round_floats", "rdiv", "softmax"]


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


class _Abs(torch.autograd.Function):
    """|x|, whose cotangent at x = 0 is +g."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``torch.abs`` with ``jnp.abs``'s derivative at 0: ``jax.vjp`` gives
    +g there and ``torch.abs``'s backward 0.  Exact zeros are common where
    the model differentiates |x|: the holes of the warped disparity in the
    fusion's correlations, and ties of bf16 features in the stereo's
    initial cost."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Abs.apply(x)
    return torch.abs(x)


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` below f32, step by step: u = exp(x - max) and
    u / w rounded, w the sum of u in f32 rounded once (``jnp.sum``
    upcasts).  The backward is ``jax.vjp``'s of those steps: g / w - r,
    times u, with r the sum over ``dim`` of g w^-2 u, each step rounded
    and the sum rounded after every add, in index order (XLA's reduce of a
    bf16 array on the CPU; ``dim`` is short where the model calls it)."""

    @staticmethod
    def forward(ctx, x, dim):
        u = torch.exp(x - x.amax(dim, keepdim=True))
        w = u.float().sum(dim, keepdim=True).to(x.dtype)
        ctx.save_for_backward(u, w)
        ctx.dim = dim
        return u / w

    @staticmethod
    def backward(ctx, g):
        u, w = ctx.saved_tensors
        z = g * (1 / (w * w)) * u
        r = torch.zeros_like(w)
        for i in range(z.shape[ctx.dim]):
            r = r + z.narrow(ctx.dim, i, 1)
        return (g / w + -r) * u, None


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax`` in f32; below f32 ``jax.nn.softmax``'s roundings
    (``torch.softmax`` rounds once, and in bf16 moves about half of the
    values by an ulp from ``codd_tpu``'s)."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.softmax(x, dim)
    return _Softmax.apply(x, dim)
