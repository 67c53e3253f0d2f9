"""Dense SE(3) Gauss-Newton step of RAFT-3D — kernels 3 and 5.

Counterpart of ``codd_tpu/ops/gn.py``.  For target pixel i,

    agg_i = sum_j sigmoid(-||ae_i - ae_j||^2) * vals_j   (|dy|,|dx| <= r)

where ``vals_j`` packs the 21 upper-triangle entries of J^T W J and the 6
of J^T W r at source pixel j (``build_vals``).  H_i and b_i unpack from
agg_i, are damped ``H += (lm*diag(H) + ep) I`` and solved by an unrolled
6x6 LL^T; a non-finite solution becomes a zero update, and the field is
retracted ``Ts <- exp(dx) * Ts``.

Two kernels share one aggregation (``csrc/gn_common.cuh``):

* ``gn_fused_solve`` (``csrc/gn_fused.cu``) replaces the TPU kernel
  ``codd_tpu/ops/pallas/gn_fused.py:gn_fused_solve`` (``pl.pallas_call``
  at :214) and does aggregate, damping and solve in one pass.
* ``gn_window_aggregate`` (``csrc/gn_window.cu``) replaces
  ``codd_tpu/ops/pallas/gn_window.py:gn_window_aggregate``
  (``pl.pallas_call`` at :153): it writes the 27 sums, and
  ``damped_solve`` runs in PyTorch, as ``codd_tpu`` solves in XLA on that
  path.

The work is two small matrix products around a sigmoid, S = Q K^T and
A = sigmoid(S) V: at 48x160 each query meets up to 65x65 keys, ~2.4 GFLOP
per call against 2 MB of operands.  Both run on the tensor cores
(``mma.sync``).  A block takes 16 query columns of 2 rows, one 16-row mma
tile a row, five warps a tile, which take the 16-key chunks of a staged
key row in turn; 2R+1 of the 2R+16 staged columns are in a query's window
and only the chunks at a row's ends are masked (``tiling_pairs``).  Key
rows arrive through a ring of three shared-memory buffers, filled by the
copy engine (``cp.async.bulk`` on an mbarrier) two rows ahead.  f32
accuracy on TF32 tensor cores comes from splitting every operand into a
TF32 high and low part and adding three products (lo.hi + hi.lo + hi.hi).
The logits are ``2 q.k - |q|^2 - |k|^2`` with the f32 norms subtracted
outside the product, as in the oracle: folding them into the product is
what failed on the TPU (``gn_fused.py:37-47``,
``codd_tpu/ops/gn.py:181-194``).  The sigmoid runs on the accumulator
fragment in registers, which then is the first operand of the second
product.  With ``bf16_scores`` the sigmoid score and the value are rounded
to bf16 before their product (one bf16 mma, exact in its f32 sum) and the
sum stays f32 (``gn_window.py:96-100``, ``codd_tpu/ops/gn.py:310-313``).
The partial sums of a tile's five warps are added in a fixed order, so a
launch gives the same bits every time.  What bounds the kernels now is
the warp schedulers' work around the mma pipe (splits, sigmoid, masks,
fragment loads), at about three times the operations bound; see
``csrc/gn_common.cuh``.

The plain versions aggregate over the dense masked (n, n) score matrix,
which is ``codd_tpu``'s ``dense`` path and equals its ``windowed`` path.

Training (``codd_tpu`` differentiates the sums with XLA): under autograd
``gn_window_aggregate`` runs as ``GNWindowAggregate``, whose backward is
``csrc/gn_window.cu``'s second kernel (``gn_window_aggregate_backward``).
With G the sums' cotangent, for a query i and a key j of its window,

    s_ij = sigmoid(-|a_i - a_j|^2)
    dvals_i = sum_j s_ij G_j                       (the window is symmetric)
    u_ij = s_ij (1 - s_ij) (G_i . v_j + G_j . v_i)
    dae_i = -2 sum_j u_ij (a_i - a_j)

so each output row is one pass over its own window, with no atomics.
With ``bf16_scores`` the backward is that kernel's second form, a kernel
of its own (``gn_window_aggregate_backward_bf16``), and computes what
``jax.vjp`` of ``codd_tpu``'s windowed form with bf16 scores computes
(``codd_tpu/ops/gn.py:268``): the dot G_i . bf16(v_j) rounded to bf16
once an ordered pair, times the derivative of the f32 sigmoid; dvals
from the bf16 scores, summed over each 32-column block of the other end,
rounded to bf16 a block and the blocks added highest first
(``gn_window_aggregate_backward_plain``).  A pre-pass of that form
writes each key's operands once into the wrapper's scratch
(``backward_bf16_scratch``; the record's layout is the kernel's): the
TF32 halves of its embedding, bf16(vals) and G as three bf16 parts that
add to G exactly (``bf16_parts``), so G_i . bf16(v_j) and S G run as
exact bf16 products.  A gradient-needing ``gn_step``
takes kernel 5 for ``auto``, ``windowed`` and ``pallas_window``
(``codd_tpu``'s training path: its ``windowed`` or, at w/8 <= 96,
``dense`` sums, the same function), with bf16 scores where ``codd_tpu``
would score in bf16, and raises for ``fused`` where ``codd_tpu`` runs
``gn_fused_solve`` (kernel 3 returns the solved update and has no
backward; ``codd_tpu``'s has no VJP).  ``grad_clip`` is ``codd_tpu``'s
straight-through clip of RAFT-3D's and the fusion net's head cotangents.

``impl`` (``codd_tpu``'s ``runtime.gn_impl``) picks the route in
``gn_step``, at every shape: ``auto`` and ``fused`` take kernel 3,
``windowed`` and ``pallas_window`` kernel 5 then ``damped_solve``;
``dense`` is the masked (n, n) form in PyTorch on whichever device, by
explicit request only.  ``codd_tpu`` runs its dense form, with f32 scores,
where its windowed paths do not apply (``resolve_impl``: radius 32, width
a multiple of 32 and > 96); the port's kernels compute the same sums
there, and drop ``bf16_scores`` there to agree with it.
"""

from __future__ import annotations

import torch

from . import kernels, se3
from ..utils.precision import rdiv
from .projective import inv_project, project

__all__ = ["gn_step", "build_system", "resolve_impl", "gn_fused_solve",
           "gn_fused_solve_plain", "gn_window_aggregate",
           "gn_window_aggregate_plain", "cholesky_solve_small", "build_vals",
           "sym_pack", "sym_unpack", "damped_solve", "tiling_pairs",
           "GN_IMPLS", "grad_clip", "GNWindowAggregate",
           "gn_window_aggregate_backward",
           "gn_window_aggregate_backward_plain", "backward_bf16_scratch",
           "bf16_parts"]

GN_IMPLS = ("auto", "fused", "windowed", "pallas_window", "dense")
_GN_BLOCK = 32  # codd_tpu's column block: the windowed paths need r == 32
_GN_QX = 16     # query columns of a block of csrc/gn_common.cuh (its QX)
_GN_CHUNK = 16  # keys a warp of it takes at a time (its CHUNK)
_GN_KREC = 132  # 32-bit words of a key's record in the bf16 backward (KREC)

_TRI = [(i, j) for i in range(6) for j in range(i, 6)]


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, clip):
        ctx.clip = clip
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        g = torch.where(g.abs() > ctx.clip, zero, g)
        return torch.where(torch.isnan(g), zero, g), None


def grad_clip(x, clip: float = 0.01):
    """Identity forward; the backward zeroes cotangent elements with
    |g| > clip, then the NaN ones (``codd_tpu/ops/gn.py:41-56``, in
    ``_gc_bwd``'s order)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradClip.apply(x, clip)
    return x


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
    Zinv = rdiv(1.0, Yz + 1e-5)
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


def gn_window_aggregate_plain(ae, vals, radius: int = 32,
                              bf16_scores: bool = False):
    """ae (B,h,w,C) pre-scaled embeddings, vals (B,h,w,27) -> the windowed
    sums (B,h,w,27), over the dense masked (n, n) score matrix."""
    B, h, w, _ = ae.shape
    _, logits, inside = _dense_logits(ae, radius)
    scores = torch.sigmoid(logits)
    v = vals.reshape(B, h * w, 27)
    if bf16_scores:
        # bf16 x bf16 products are exact in f32; the sum stays f32
        scores = scores.to(torch.bfloat16).float()
        v = v.to(torch.bfloat16).float()
    scores = scores * inside[None].to(ae.dtype)
    return torch.bmm(scores, v).reshape(B, h, w, 27)


def _backward_dense(g, ae, vals, radius, bf16_scores=False):
    """The dense masked (n, n) factors of the windowed sums' VJP: q (B,n,C),
    the scores S (B,n,n) that multiply G, G (B,n,27) and U, the logits'
    cotangent summed over both orders of a pair.  f32 scores: U = S (1 - S)
    (G V^T + V G^T).  bf16 scores, step by step as ``jax.vjp`` of
    ``_windowed_aggregate(bf16_scores=True)``: dS_ij = bf16(G_i . bf16(v_j))
    rounded once an ordered pair, dlogit_ij = dS_ij s_ij (1 - s_ij) with the
    f32 sigmoid s, U = dlogit + dlogit^T, and S = bf16(s)."""
    B, h, w, _ = ae.shape
    q, logits, inside = _dense_logits(ae, radius)
    mask = inside[None].to(ae.dtype)
    s = torch.sigmoid(logits)
    G = g.reshape(B, h * w, 27)
    V = vals.reshape(B, h * w, 27)
    if not bf16_scores:
        s = s * mask
        P = torch.bmm(G, V.transpose(1, 2))
        return q, s, G, s * (1.0 - s) * (P + P.transpose(1, 2))
    bf = torch.bfloat16
    dS = torch.bmm(G, V.to(bf).float().transpose(1, 2)).to(bf).float()
    dlogit = (dS * mask) * (s * (1.0 - s))
    return q, s.to(bf).float() * mask, G, dlogit + dlogit.transpose(1, 2)


def _block_dvals(s, G, w):
    """dvals under bf16 scores: for each 32-column block k of queries, its
    sums t_k = S^T G over the block's queries, rounded to bf16, added in f32
    highest block first, ((0 + t_{nb-1}) + ...) + t_0: ``jax.vjp`` of
    ``_windowed_aggregate``'s pads and adds of the blocks' key cotangents
    (a key meets blocks m - 1, m, m + 1; the others add exact zeros)."""
    n = G.shape[1]
    block = (torch.arange(n, device=G.device) % w) // _GN_BLOCK
    out = torch.zeros_like(G)
    for k in reversed(range(-(-w // _GN_BLOCK))):
        t = torch.bmm(s.transpose(1, 2), G * (block == k)[None, :, None])
        out = out + t.to(torch.bfloat16).float()
    return out


def gn_window_aggregate_backward_plain(g, ae, vals, radius: int = 32,
                                       bf16_scores: bool = False):
    """The VJP of the windowed sums at (ae, vals) for the cotangent g
    (B,h,w,27) -> (dae (B,h,w,C), dvals (B,h,w,27)), over the dense masked
    (n, n) scores: dvals = S^T G, U as ``_backward_dense`` gives it, dae =
    -2 (rowsum(U) a - U a), which is what autodiff of ``codd_tpu``'s dense
    form computes (f32 scores), or of its windowed form with
    ``bf16_scores`` (then dvals sums bf16-rounded 32-column blocks,
    ``_block_dvals``; the form exists where w is a multiple of 32 above
    96)."""
    q, s, G, u = _backward_dense(g, ae, vals, radius, bf16_scores)
    dae = -2.0 * (u.sum(-1, keepdim=True) * q - torch.bmm(u, q))
    if bf16_scores:
        dvals = _block_dvals(s, G, ae.shape[2])
    else:
        dvals = torch.bmm(s.transpose(1, 2), G)
    return dae.reshape(ae.shape), dvals.reshape(vals.shape)


def gn_window_aggregate_backward_terms(g, ae, vals, radius: int = 32,
                                       bf16_scores: bool = False):
    """Each output's sum of |terms| in the VJP above: sum_j 2 |u_ij|
    (|a_i| + |a_j|) a channel for dae, whose two sums cancel, and
    sum_j s_ij |G_j| for dvals (with ``bf16_scores``, U from the rounded
    dS and the rounded scores).  The scale that f32 sums of the same terms
    in another order are held to; under bf16 scores a term's rounding to
    bf16 may flip too, by one bf16 ulp, 2^-7 of it at most."""
    q, s, G, u = _backward_dense(g, ae, vals, radius, bf16_scores)
    u, qa = u.abs(), q.abs()
    dae = 2.0 * (u.sum(-1, keepdim=True) * qa + torch.bmm(u, qa))
    return (dae.reshape(ae.shape),
            torch.bmm(s.transpose(1, 2), G.abs()).reshape(vals.shape))


def gn_fused_solve_plain(ae, vals, radius: int = 32, lm: float = 1e-4,
                         ep: float = 10.0, bf16_scores: bool = False):
    """ae (B,h,w,C) pre-scaled embeddings, vals (B,h,w,27) -> dx (B,h,w,6)."""
    return damped_solve(gn_window_aggregate_plain(ae, vals, radius,
                                                  bf16_scores), lm, ep)


def _check_gn(name, ae, vals):
    B, h, w, C = ae.shape
    kernels.check_cuda(name, ae, vals, dtypes=(torch.float32, torch.float32))
    if C != 32 or tuple(vals.shape) != (B, h, w, 27):
        raise ValueError(f"{name}: bad shapes ae {tuple(ae.shape)} "
                         f"vals {tuple(vals.shape)} (needs C == 32)")
    if ae.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError(f"{name}: ae or vals is not 16-byte aligned (the "
                         "kernel stages their rows as 16-byte copies)")
    return B, h, w


def tiling_pairs(h: int, w: int, radius: int = 32) -> int:
    """Query-key pairs the CUDA aggregation evaluates on an (h, w) field:
    every tile of ``_GN_QX`` queries of a row meets each staged column, in
    whole chunks of ``_GN_CHUNK``, of each row of its window, inside a
    query's own window or masked.  Against the useful pairs this is the
    share of its work the tiling throws away."""
    rows = sum(min(y + radius, h - 1) - max(y - radius, 0) + 1
               for y in range(h))
    cols = 0
    for x0 in range(0, w, _GN_QX):
        nk = min(x0 + _GN_QX - 1 + radius, w - 1) - max(x0 - radius, 0) + 1
        cols += -(-nk // _GN_CHUNK) * _GN_CHUNK
    return _GN_QX * rows * cols


def gn_fused_solve(ae, vals, radius: int = 32, lm: float = 1e-4,
                   ep: float = 10.0, bf16_scores: bool = False):
    """Kernel 3 for CUDA tensors, the plain version for CPU tensors."""
    if not ae.is_cuda:
        return gn_fused_solve_plain(ae, vals, radius, lm, ep, bf16_scores)
    kernels.check_forward_only("gn_fused_solve", ae, vals)
    B, h, w = _check_gn("gn_fused_solve", ae, vals)
    out = torch.empty((B, h, w, 6), dtype=torch.float32, device=ae.device)
    kernels.launch("gn_fused_solve", ae.data_ptr(), vals.data_ptr(),
                   out.data_ptr(), B, h, w, radius, float(lm), float(ep),
                   int(bool(bf16_scores)), kernels.stream_ptr(ae.device))
    return out


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _launch_window(ae, vals, radius, bf16_scores):
    B, h, w = _check_gn("gn_window_aggregate", ae, vals)
    out = torch.empty((B, h, w, 27), dtype=torch.float32, device=ae.device)
    kernels.launch("gn_window_aggregate", ae.data_ptr(), vals.data_ptr(),
                   out.data_ptr(), B, h, w, radius, int(bool(bf16_scores)),
                   kernels.stream_ptr(ae.device))
    return out


def gn_window_aggregate_backward(g, ae, vals, radius: int = 32,
                                 bf16_scores: bool = False):
    """Kernel 5's backward for CUDA tensors (its bf16-score form, a kernel
    of its own, with ``bf16_scores``; R = 32 there), the plain version for
    CPU tensors -> (dae, dvals), f32."""
    if not ae.is_cuda:
        return gn_window_aggregate_backward_plain(g, ae, vals, radius,
                                                  bf16_scores)
    name = "gn_window_aggregate_backward" + ("_bf16" if bf16_scores else "")
    B, h, w = _check_gn(name, ae, vals)
    kernels.check_cuda(name, g, dtypes=(torch.float32,))
    if tuple(g.shape) != (B, h, w, 27):
        raise ValueError(f"{name}: g {tuple(g.shape)} (needs {(B, h, w, 27)})")
    if bf16_scores and radius != _GN_BLOCK:
        raise ValueError(f"{name}: radius {radius}; the bf16-score form is "
                         f"codd_tpu's windowed one, radius {_GN_BLOCK}")
    dae = torch.empty_like(ae)
    dvals = torch.empty_like(vals)
    # the bf16 form's key records, held until the launch is queued
    recs = [backward_bf16_scratch(ae)] if bf16_scores else []
    kernels.launch(name, ae.data_ptr(), vals.data_ptr(), g.data_ptr(),
                   *(r.data_ptr() for r in recs), dae.data_ptr(),
                   dvals.data_ptr(), B, h, w, radius,
                   kernels.stream_ptr(ae.device))
    return dae, dvals


def backward_bf16_scratch(ae):
    """The bf16-score backward's scratch: a ``_GN_KREC``-word record for
    each key of (B, h, w rounded up to whole chunks), which its pre-pass
    writes (csrc/gn_window.cu: gn_backward_bf16_keys_kernel)."""
    B, h, w, _ = ae.shape
    wp = -(-w // _GN_CHUNK) * _GN_CHUNK
    return torch.empty((B, h, wp, _GN_KREC), dtype=torch.int32,
                       device=ae.device)


def bf16_parts(x):
    """x (f32) as three bf16 values hi + mid + lo that add to x exactly
    (x - hi and (x - hi) - mid are exact in f32), each as f32."""
    def r(t):
        return t.to(torch.bfloat16).float()
    hi = r(x)
    mid = r(x - hi)
    return hi, mid, r((x - hi) - mid)


class GNWindowAggregate(torch.autograd.Function):
    """The windowed sums with kernel 5's backward, f32 or bf16 scores (the
    forward in the same form, also where ``torch.utils.checkpoint``
    recomputes it)."""

    @staticmethod
    def forward(ctx, ae, vals, radius, bf16_scores=False):
        ctx.radius, ctx.bf16 = radius, bool(bf16_scores)
        ctx.save_for_backward(ae, vals)
        if not ae.is_cuda:
            return gn_window_aggregate_plain(ae, vals, radius, ctx.bf16)
        return _launch_window(ae, vals, radius, ctx.bf16)

    @staticmethod
    def backward(ctx, g):
        dae, dvals = gn_window_aggregate_backward(
            g.contiguous(), *ctx.saved_tensors, ctx.radius, ctx.bf16)
        return dae, dvals, None, None


def gn_window_aggregate(ae, vals, radius: int = 32,
                        bf16_scores: bool = False):
    """Kernel 5 for CUDA tensors, the plain version for CPU tensors; through
    ``GNWindowAggregate`` when autograd needs its gradient."""
    if _needs_grad(ae, vals):
        return GNWindowAggregate.apply(ae, vals, radius, bool(bf16_scores))
    if not ae.is_cuda:
        return gn_window_aggregate_plain(ae, vals, radius, bf16_scores)
    return _launch_window(ae, vals, radius, bf16_scores)


def resolve_impl(impl: str, radius: int, w: int) -> str:
    """The aggregation path ``codd_tpu`` takes for ``impl`` on a 1/8-res
    field of width ``w`` (``codd_tpu/ops/gn.py:132-142``).  The port's
    kernels take every shape, so this picks no route here; it only says
    where ``codd_tpu`` runs its dense form, which keeps f32 scores whatever
    ``bf16_scores`` says."""
    windowed_ok = (radius == _GN_BLOCK and w % _GN_BLOCK == 0
                   and w > 3 * _GN_BLOCK)
    if impl == "auto":
        return "windowed" if windowed_ok else "dense"
    if impl in ("windowed", "pallas_window", "fused") and not windowed_ok:
        return "dense"
    return impl


_ROUTES = {"auto": "fused", "fused": "fused", "windowed": "window",
           "pallas_window": "window", "dense": "dense"}


def _route(impl: str, radius: int, w: int, bf16_scores: bool = False,
           grad: bool = False):
    """(route, bf16): which code computes the sums for ``impl`` (``fused``
    kernel 3, ``window`` kernel 5, ``dense`` the (n, n) form), at every
    shape, and whether the scores are rounded to bf16: only where
    ``codd_tpu`` would not run its dense form.  With ``grad`` (autograd
    needs the sums' gradient) ``auto`` is ``window`` (bf16 scores too:
    kernel 5's backward has their form) and kernel 3, which has no
    backward, raises where ``codd_tpu`` would run it.  Where ``codd_tpu``
    runs its dense form instead, it trains that with f32 scores, and the
    port trains ``fused`` as ``auto``."""
    if impl not in GN_IMPLS:
        raise ValueError(f"bad GN impl {impl!r}; one of {GN_IMPLS}")
    resolved = resolve_impl(impl, radius, w)
    bf16 = bool(bf16_scores) and resolved != "dense"
    if grad and resolved == "fused":
        raise NotImplementedError(
            f"gn_step: gn_impl={impl!r} at a width of {w} has no backward "
            "(kernel 3 returns the solved update; codd_tpu has no VJP of "
            "gn_fused_solve); train with gn_impl auto, windowed or "
            "pallas_window")
    route = _ROUTES[impl]
    if grad and route == "fused":
        route = "window"
    return route, bf16


def _aggregate(ae, vals, radius, route, bf16):
    """ae pre-scaled; the (B,h,w,27) sums by kernel 5 (``window``) or, for
    an explicit ``dense``, the (n, n) form on whichever device."""
    if route == "dense":
        return gn_window_aggregate_plain(ae, vals, radius, bf16)
    return gn_window_aggregate(ae, vals, radius, bf16)


def build_system(Ts, ae, target, weight, depth, intrinsics, radius: int = 32,
                 impl: str = "auto", bf16_scores: bool = False):
    """Attention-aggregated normal equations (H (B,h,w,6,6), b (B,h,w,6));
    ``ae`` pre-scaled.  Where ``gn_step`` would take kernel 3, which
    returns the solved update and not the system, the sums come from
    ``windowed``'s route."""
    vals = build_vals(Ts, target, weight, depth, intrinsics).contiguous()
    route, bf16 = _route(impl, radius, Ts.shape[2], bf16_scores,
                         _needs_grad(Ts, ae, target, weight, depth))
    if route == "fused":
        route = "window"
    agg = _aggregate(ae.float().contiguous(), vals, radius, route, bf16)
    return sym_unpack(agg[..., :21]), agg[..., 21:]


def gn_step(Ts, ae, target, weight, depth, intrinsics, radius: int = 32,
            lm: float = 1e-4, ep: float = 10.0, impl: str = "auto",
            bf16_scores: bool = False):
    """One damped GN update of the SE(3) field Ts (B,h,w,7); ae is scaled
    by 1/8 as in the reference (se3_field.py:150-170).  The kernels take
    ``ae`` and the value field in f32; the f32 update is cast to Ts's
    dtype before ``exp``, as in ``codd_tpu``."""
    grad = _needs_grad(Ts, ae, target, weight, depth)
    vals = build_vals(Ts, target, weight, depth, intrinsics).contiguous()
    ae = (ae / 8.0).float().contiguous()
    route, bf16 = _route(impl, radius, Ts.shape[2], bf16_scores, grad)
    if route == "fused":
        dx = gn_fused_solve(ae, vals, radius, lm, ep, bf16)
    else:
        dx = damped_solve(_aggregate(ae, vals, radius, route, bf16), lm, ep)
    return se3.mul(se3.exp(dx.to(Ts.dtype)), Ts)
