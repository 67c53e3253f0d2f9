"""Closed-form dense SE(3) fields (counterpart of ``codd_tpu/ops/se3.py``).

A transform is a trailing-7 tensor ``[tx, ty, tz, qx, qy, qz, qw]``
(translation + unit quaternion, lietorch's layout); a twist is a
trailing-6 ``[v, w]``.  All functions broadcast over leading dims.
``act``, ``mul``, ``exp`` and ``log`` run in float32 whatever the field's
dtype and cast the result back to the dtype of their first argument, as
``codd_tpu``'s ``_f32_internal`` does: the small-angle series and the
quaternion normalisation cancel catastrophically in bfloat16.
"""

from __future__ import annotations

import functools

import torch

from ..utils.precision import rdiv

__all__ = ["identity", "exp", "log", "mul", "act", "quat_rotate"]

_EPS = 1e-8


def _f32_internal(fn):
    """Run ``fn`` in f32 and cast its result to the first argument's
    dtype; an f32 first argument runs ``fn`` on the arguments as given."""
    @functools.wraps(fn)
    def wrapped(*args):
        dtype = args[0].dtype
        if dtype == torch.float32:
            return fn(*args)
        return fn(*(a.float() for a in args)).to(dtype)
    return wrapped


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def identity(shape, dtype=torch.float32, device=None):
    """Identity transforms of the given leading shape -> (*shape, 7)."""
    data = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    data[..., 6] = 1.0
    return data


def quat_rotate(q, p):
    """Rotate points p (...,3) by unit quaternions q (...,4) [x,y,z,w]."""
    qv = q[..., :3]
    t = 2.0 * _cross(qv, p)
    return p + q[..., 3:4] * t + _cross(qv, t)


@_f32_internal
def act(g, p):
    """Group action on points: R p + t.  g (...,7), p (...,3)."""
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


def _quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], -1)


@_f32_internal
def mul(a, b):
    """Compose transforms: (a * b)(p) = a(b(p))."""
    q = _quat_mul(a[..., 3:7], b[..., 3:7])
    t = quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    return torch.cat([t, q], -1)


def _sinc_coeffs(theta2):
    """Taylor-safe A=sin t/t, B=(1-cos t)/t^2, C=(t-sin t)/t^3."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - A) / (theta2 + _EPS))
    return A, B, C


@_f32_internal
def exp(tau):
    """Exponential map se(3) -> SE(3).  tau (...,6) = [v, w]."""
    v = tau[..., :3]
    w = tau[..., 3:6]
    theta2 = torch.sum(w * w, -1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    q = torch.cat([s * w, qw], -1)
    _, B, C = _sinc_coeffs(theta2)
    wxv = _cross(w, v)
    t = v + B * wxv + C * _cross(w, wxv)
    return torch.cat([t, q], -1)


@_f32_internal
def log(g):
    """Logarithm map SE(3) -> se(3) -> (...,6) = [v, w]."""
    t = g[..., :3]
    qv = g[..., 3:6]
    qw = g[..., 6:7]
    qn = torch.sqrt(torch.sum(qv * qv, -1, keepdim=True) + _EPS)
    theta = 2.0 * torch.atan2(qn, torch.abs(qw)) * torch.sign(qw)
    small = qn ** 2 < 1e-8
    scale = torch.where(small, rdiv(2.0, torch.clamp(qw, min=_EPS)),
                        theta / qn)
    w = scale * qv
    theta2 = torch.sum(w * w, -1, keepdim=True)
    A, B, _ = _sinc_coeffs(theta2)
    # Above codd_tpu's Taylor threshold, 1 - cos t still rounds to 0 in f32
    # for t < ~3.4e-4 (theta2 < ~1.1e-7): there B is 0 and codd_tpu's D is
    # -inf, which makes v inf or NaN.  Only there the series is taken (and
    # B is replaced before the division, so the unused branch's gradient
    # stays finite); everywhere else D is codd_tpu's expression.
    flat = B == 0
    D = torch.where((theta2 < 1e-8) | flat, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - A / (2.0 * torch.where(flat, torch.ones_like(B),
                                                  B))) / (theta2 + _EPS))
    wxt = _cross(w, t)
    v = t - 0.5 * wxt + D * _cross(w, wxt)
    return torch.cat([v, w], -1)
