"""Dense SE(3) Gauss-Newton step of RAFT-3D — kernel 3's plain form
(``runtime.gn_impl`` ``auto`` in inference).

Counterpart of ``codd_tpu/ops/gn.py``.  For target pixel i,

    agg_i = sum_j sigmoid(-||ae_i - ae_j||^2) * vals_j   (|dy|,|dx| <= r)

where ``vals_j`` packs the 21 upper-triangle entries of J^T W J and the 6
of J^T W r at source pixel j (``build_vals``).  H_i and b_i unpack from
agg_i, are damped ``H += (lm*diag(H) + ep) I`` and solved by an unrolled
6x6 LL^T; a non-finite solution becomes a zero update, and the field is
retracted ``Ts <- exp(dx) * Ts``.  The sums run over the dense masked
(n, n) score matrix, ``codd_tpu``'s ``dense`` path, which equals its
``windowed`` path; ``codd_torch``'s ``csrc/gn_fused.cu`` does aggregate,
damping and solve in one pass."""

from __future__ import annotations

import torch

from . import se3
from .projective import inv_project, project

__all__ = ["gn_step", "gn_fused_solve", "gn_window_aggregate_plain",
           "cholesky_solve_small", "build_vals", "sym_pack", "sym_unpack",
           "damped_solve"]

_TRI = [(i, j) for i in range(6) for j in range(i, 6)]


def cholesky_solve_small(H, b):
    """Solve H x = b for SPD H (..., n, n), b (..., n) by an unrolled LL^T."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def sym_pack(M):
    """(..., 6, 6) symmetric -> (..., 21) upper-triangle entries."""
    return torch.stack([M[..., i, j] for i, j in _TRI], -1)


def sym_unpack(p):
    """(..., 21) -> (..., 6, 6) symmetric."""
    rows = [[None] * 6 for _ in range(6)]
    for k, (i, j) in enumerate(_TRI):
        rows[i][j] = rows[j][i] = p[..., k]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def build_vals(Ts, target, weight, depth, intrinsics):
    """The per-pixel value field (B,h,w,27) f32: sym_pack(J^T W J) | J^T W r.
    Built in f32 whatever the fields' dtype (``codd_tpu/ops/gn.py:
    _build_vals``)."""
    X = inv_project(depth, intrinsics).float()
    Y = se3.act(Ts.float(), X)
    r = target.float() - project(Y, intrinsics)
    fx = intrinsics[:, 0, None, None].float()
    fy = intrinsics[:, 1, None, None].float()
    weight = weight.float()
    Yx, Yy, Yz = Y.unbind(-1)
    Zinv = 1.0 / (Yz + 1e-5)
    Z2inv = Zinv * Zinv
    zero = torch.zeros_like(Zinv)
    Jpi = torch.stack([
        torch.stack([fx * Zinv, zero, -fx * Yx * Z2inv], -1),
        torch.stack([zero, fy * Zinv, -fy * Yy * Z2inv], -1),
        torch.stack([zero, zero, -Z2inv], -1)], -2)          # (B,h,w,3,3)
    J = torch.cat([Jpi, -torch.einsum("...ij,...jk->...ik", Jpi, _skew(Y))],
                  -1)                                          # (B,h,w,3,6)
    M = torch.einsum("...ki,...kj->...ij", J, J * weight[..., None])
    v = torch.einsum("...ki,...k->...i", J, weight * r)
    return torch.cat([sym_pack(M), v], -1)


def damped_solve(agg, lm: float = 1e-4, ep: float = 10.0):
    """agg (...,27) -> dx (...,6): damp, LL^T solve, non-finite -> 0."""
    H = sym_unpack(agg[..., :21])
    eye = torch.eye(6, dtype=agg.dtype, device=agg.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    H = H + (lm * diag + ep)[..., None] * eye
    dx = cholesky_solve_small(H, agg[..., 21:])
    return torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx,
                       torch.zeros_like(dx))


def _dense_logits(ae, radius):
    """ae (B,h,w,C) -> q (B,n,C), the dense logits -|a_i - a_j|^2 (B,n,n)
    and the Chebyshev window's mask (n,n)."""
    B, h, w, C = ae.shape
    n = h * w
    q = ae.reshape(B, n, C)
    sq = torch.sum(q * q, -1)
    logits = (2.0 * torch.bmm(q, q.transpose(1, 2))
              - sq[:, :, None] - sq[:, None, :])
    ys = torch.arange(n, device=ae.device) // w
    xs = torch.arange(n, device=ae.device) % w
    inside = (((ys[:, None] - ys[None, :]).abs() <= radius)
              & ((xs[:, None] - xs[None, :]).abs() <= radius))
    return q, logits, inside


def gn_window_aggregate_plain(ae, vals, radius: int = 32):
    """ae (B,h,w,C) pre-scaled embeddings, vals (B,h,w,27) -> the windowed
    sums (B,h,w,27), over the dense masked (n, n) score matrix."""
    B, h, w, _ = ae.shape
    _, logits, inside = _dense_logits(ae, radius)
    scores = torch.sigmoid(logits)
    v = vals.reshape(B, h * w, 27)
    scores = scores * inside[None].to(ae.dtype)
    return torch.bmm(scores, v).reshape(B, h, w, 27)


def gn_fused_solve(ae, vals, radius: int = 32, lm: float = 1e-4,
                   ep: float = 10.0):
    """ae (B,h,w,C) pre-scaled embeddings, vals (B,h,w,27) -> dx (B,h,w,6):
    what one launch of kernel 3 computes."""
    return damped_solve(gn_window_aggregate_plain(ae, vals, radius), lm, ep)


def gn_step(Ts, ae, target, weight, depth, intrinsics, radius: int = 32,
            lm: float = 1e-4, ep: float = 10.0):
    """One damped GN update of the SE(3) field Ts (B,h,w,7); ae is scaled
    by 1/8 as in the reference (se3_field.py:150-170)."""
    vals = build_vals(Ts, target, weight, depth, intrinsics).contiguous()
    ae = (ae / 8.0).float().contiguous()
    dx = gn_fused_solve(ae, vals, radius, lm, ep)
    return se3.mul(se3.exp(dx.to(Ts.dtype)), Ts)
