"""Dense SE(3) Gauss-Newton step of RAFT-3D — kernel 3.

Counterpart of ``codd_tpu/ops/gn.py`` (forward only).  For target pixel i,

    agg_i = sum_j sigmoid(-||ae_i - ae_j||^2) * vals_j   (|dy|,|dx| <= r)

where ``vals_j`` packs the 21 upper-triangle entries of J^T W J and the 6
of J^T W r at source pixel j (``_build_vals``).  H_i and b_i unpack from
agg_i, are damped ``H += (lm*diag(H) + ep) I`` and solved by an unrolled
6x6 LL^T; a non-finite solution becomes a zero update, and the field is
retracted ``Ts <- exp(dx) * Ts``.

The kernel (``csrc/gn_fused.cu``) replaces the TPU kernel
``codd_tpu/ops/pallas/gn_fused.py:gn_fused_solve`` (``pl.pallas_call`` at
:214) and does aggregate, damping and solve in one pass, all in f32.  On
the H100 it is bound by operations: at 48x160 each query meets up to
65x65 keys, ~130 f32 flops each (a 32-wide dot, a sigmoid, 27
multiply-adds), ~3 GFLOP per call against 2 MB of operands.  One block
per 32-query row segment streams the key rows of its 65-row window
through shared memory, where every warp reads one key at a time as a
broadcast; eight warps split the columns of a row and sum their partials
in a fixed order before the solve.  The logits are ``2 q.k - |q|^2 - |k|^2``
with the norms subtracted outside the dot product, as in the oracle:
folding them into the product failed on the TPU at rel 2e-2
(``gn_fused.py:37-47``).  The plain version (``gn_fused_solve_plain``)
aggregates over the dense masked (n, n) score matrix, which is exactly
``codd_tpu``'s ``dense`` path and equals its ``windowed`` path.
"""

from __future__ import annotations

import torch

from . import kernels, se3
from .projective import inv_project, project

__all__ = ["gn_step", "gn_fused_solve", "gn_fused_solve_plain",
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
    """The per-pixel value field (B,h,w,27): sym_pack(J^T W J) | J^T W r."""
    X = inv_project(depth, intrinsics)
    Y = se3.act(Ts, X)
    r = target - project(Y, intrinsics)
    fx = intrinsics[:, 0, None, None]
    fy = intrinsics[:, 1, None, None]
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


def gn_fused_solve_plain(ae, vals, radius: int = 32, lm: float = 1e-4,
                         ep: float = 10.0):
    """ae (B,h,w,C) pre-scaled embeddings, vals (B,h,w,27) -> dx (B,h,w,6)."""
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
    scores = torch.sigmoid(logits) * inside[None].to(ae.dtype)
    agg = torch.bmm(scores, vals.reshape(B, n, 27)).reshape(B, h, w, 27)
    return damped_solve(agg, lm, ep)


def gn_fused_solve(ae, vals, radius: int = 32, lm: float = 1e-4,
                   ep: float = 10.0):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if not ae.is_cuda:
        return gn_fused_solve_plain(ae, vals, radius, lm, ep)
    B, h, w, C = ae.shape
    kernels.check_cuda("gn_fused_solve", ae, vals,
                       dtypes=(torch.float32, torch.float32))
    if C != 32 or tuple(vals.shape) != (B, h, w, 27):
        raise ValueError(f"gn_fused_solve: bad shapes ae {tuple(ae.shape)} "
                         f"vals {tuple(vals.shape)} (needs C == 32)")
    out = torch.empty((B, h, w, 6), dtype=torch.float32, device=ae.device)
    kernels.launch("gn_fused_solve", ae.data_ptr(), vals.data_ptr(),
                   out.data_ptr(), B, h, w, radius, float(lm), float(ep),
                   kernels.stream_ptr(ae.device))
    return out


def gn_step(Ts, ae, target, weight, depth, intrinsics, radius: int = 32,
            lm: float = 1e-4, ep: float = 10.0):
    """One damped GN update of the SE(3) field Ts (B,h,w,7); ae is scaled
    by 1/8 as in the reference (se3_field.py:150-170)."""
    vals = build_vals(Ts, target, weight, depth, intrinsics)
    dx = gn_fused_solve((ae / 8.0).contiguous(), vals.contiguous(), radius,
                        lm, ep)
    return se3.mul(se3.exp(dx), Ts)
