"""Z-buffered point splatting (forward warping) of the motion module —
kernel 4.

Counterpart of ``codd_tpu/ops/splat.py`` on its inference path
(``_splat_one_gather``, ``splat.py:157-247``).  Every point projects into
the image and covers the pixels whose centres lie within ``radius_px``
with alpha ``1 - d^2/r^2`` (clipped to 1 - 1e-4, in f32).  Fragments on a
pixel composite front to back in depth order with weight
``alpha_i * prod_{j<i}(1 - alpha_j)``, capped at ``points_per_pixel``; the
depth buffer is the nearest fragment's z (0 where nothing lands).

Fragments are ordered by ``torch.sort`` of the packed key
``(pixel << z_bits) | top z_bits of z`` (``_quantize_z``; 13 bits at
384x1280, 17 at 96x320), stable, so near-equal depths tie-break on the
fragment index deterministically where ``jax.lax.sort(is_stable=False)``
orders them arbitrarily.  ``torch.searchsorted`` gives each pixel's run.

The compositor (``csrc/splat_composite.cu``) replaces the TPU kernel
``codd_tpu/ops/pallas/splat_composite.py:composite_tiles``
(``pl.pallas_call`` at :165), with no per-tile overflow drop (a documented
divergence of the Pallas kernel that the port does not copy), in one
launch of one of two forms, chosen by C.  For C <= 8 a thread walks its
pixel's run with the sums in registers (the full-res call: C=6, ~2-3
fragments a pixel, bound by its gathers' traffic).  For wider features
eight lanes of a warp take a pixel, four channels each: they read the
ids and alphas of the run's first ``points_per_pixel`` fragments a lane a
fragment, share them by shuffles, and load feature rows across the lanes
(the quarter-res call: C=32, ~9-12 fragments a pixel, too few pixels to
hide a walk's dependent loads).  Each output is the same sequence of
rounded operations as a walk of its pixel's run, for any C and any run
length.  On the H100 the work is bytes: per pixel its offset and outputs;
for the fragments it composites (the first ``points_per_pixel`` of each
run) an 8-byte id and a 4-byte alpha; the feature rows and front depths
of their points (~50 MB at the full-res C=6 call, ~11 MB at the
quarter-res C=32 call); the XLA path instead runs a segmented scan, a
global (M, C+2) cumsum and a second sort.

Training (``codd_tpu``'s ``splat_impl_train``, ``_splat_one_sort``,
``splat.py:76``): its forward is ``_splat_one_gather``'s function with
the features riding the sort, so the port's training forward is kernel 4
unchanged, run as ``SplatComposite`` when autograd needs a gradient of
the points or the features.  Its backward (``composite_backward``,
``csrc/splat_composite.cu``'s backward kernels) gives, for a
pixel's run in key order with weights ``w_i = a_i T_i`` and cotangents g,
gz: ``dfeat[n] += w_i g`` over the fragments i of point n, ``dalpha_i =
T_i (g . f_i) - (1 / (1 - a_i)) sum_{i<k<ppp} w_k (g . f_k)`` (0 past
``points_per_pixel``), and ``dZ`` of the run's front point ``+= gz``; the
key, its z quantisation and the ranks carry no gradient.  The projection
(``_project_fragments``) stays plain PyTorch under autograd, so ``dalpha``
reaches the points through ``alpha = 1 - d^2/r^2`` (0 where the clip at
``1 - 1e-4`` binds, as in ``codd_tpu``).  Two launches, no float atomics:
the first walks each run (a lane a fragment, so ``points_per_pixel <=
8``: eight lanes a pixel for C <= 8, a warp a pixel above, four lanes
sharing each fragment's dot) and writes each fragment's weight and
``dalpha``; the second sums each point's K fragments in order; two runs
give the same bits.
"""

from __future__ import annotations

import math

import torch

from . import kernels

__all__ = ["splat_render", "composite", "composite_plain",
           "composite_backward", "composite_backward_plain",
           "composite_backward_terms", "SplatComposite"]

WALK_C = 8  # channels the walk holds in registers (csrc/splat_composite.cu)
BWD_PPP = 8  # the backward's lanes a pixel: points_per_pixel at most
# the kernel's forms, by the launcher's code ("auto" chooses by C)
FORMS = {"auto": 0, "walk": 1, "lanes": 2}


def _quantize_z(z, z_bits: int):
    """Top ``z_bits`` bits of the f32 encoding of z, as an unsigned code."""
    bits = z.detach().float().contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF
    return bits >> (32 - z_bits)


def _project_fragments(points, intrinsics, H, W, radius_px,
                       pixel_center_offset, npix_sentinel):
    """points (N,3) -> tap-major flat fragments (K*N,): pixel id (sentinel
    where culled), alpha; and the point depths Z (N,)."""
    R = int(math.ceil(radius_px))
    fx, fy, cx, cy = intrinsics.unbind(0)
    X, Y, Z = points.unbind(-1)
    zvalid = Z > 1e-4
    zs = torch.where(zvalid, Z, torch.ones_like(Z))
    x = fx * (X / zs) + cx + pixel_center_offset
    y = fy * (Y / zs) + cy + pixel_center_offset
    offs = torch.arange(-(R - 1), R + 1, device=points.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    px = torch.floor(x).long()[None, :] + dx.reshape(-1, 1)     # (K, N)
    py = torch.floor(y).long()[None, :] + dy.reshape(-1, 1)
    d2 = (px.float() - x[None]) ** 2 + (py.float() - y[None]) ** 2
    alpha = 1.0 - d2 / (radius_px * radius_px)
    ok = ((alpha > 0) & (px >= 0) & (px < W) & (py >= 0) & (py < H)
          & zvalid[None])
    pid = torch.where(ok, py * W + px, torch.full_like(px, npix_sentinel))
    alpha = torch.where(ok, alpha.clamp(0.0, 1.0 - 1e-4),
                        torch.zeros_like(alpha))
    return pid.reshape(-1), alpha.reshape(-1), Z


def _runs(order, offsets, N):
    """The pixel, in-run rank and point of every fragment in a run, in
    sorted order, and the run lengths (the plain versions' bookkeeping)."""
    npix = offsets.numel() - 1
    counts = offsets[1:] - offsets[:-1]
    Mr = int(offsets[-1])
    dev = order.device
    pid = torch.repeat_interleave(torch.arange(npix, device=dev), counts)
    rank = torch.arange(Mr, device=dev) - offsets[:-1][pid]
    return pid, rank, order[:Mr] % N, counts


def composite_plain(order, offsets, alpha, z, feat, points_per_pixel=8):
    """order (M,) int64 fragment ids sorted by (pixel, z); offsets (npix+1,)
    int64 run starts; alpha (M,) f32 per fragment id (tap-major, point id
    = fragment id % N); z (N,), feat (N,C) f32.
    Returns out (npix,C), zbuf (npix,), count (npix,) f32."""
    N, C = feat.shape
    npix = offsets.numel() - 1
    dev = feat.device
    pid, rank, n, counts = _runs(order, offsets, N)
    Mr = pid.numel()
    a = alpha[order[:Mr]]
    # exclusive in-run sum of log(1 - alpha), in f64 so the global prefix
    # sums do not cancel
    la = torch.log1p(-a).double()
    excl = torch.cumsum(la, 0) - la
    excl = excl - excl[offsets[:-1][pid]]
    wgt = a * torch.exp(excl).float() * (rank < points_per_pixel).float()
    out = torch.zeros((npix, C), dtype=torch.float32, device=dev)
    out.index_add_(0, pid, feat[n] * wgt[:, None])
    head = offsets[:-1].clamp(max=max(Mr - 1, 0))
    zhead = z[order[head] % N] if Mr > 0 else torch.zeros(npix, device=dev)
    cnt = counts.float()
    return out, torch.where(cnt > 0, zhead, torch.zeros_like(zhead)), cnt


def composite_backward_plain(order, offsets, alpha, feat, g, gz,
                             points_per_pixel=8):
    """The VJP of ``composite_plain``'s (out, zbuf) at (alpha, z, feat) for
    the cotangents g (npix,C) and gz (npix,) -> dfeat (N,C), dalpha (M,)
    at each fragment id, dz (N,), f32: the transmittance and the in-run
    suffix sum of ``w_k (g . f_k)`` in f64 along each run, ``index_add_``
    for the points' sums."""
    return _backward(order, offsets, alpha, feat, g, gz, points_per_pixel,
                     -1.0)


def composite_backward_terms(order, offsets, alpha, feat, g, gz,
                             points_per_pixel=8):
    """Each output's sum of |terms| for ``composite_backward``: the plain
    backward on |g|, |feat| and |gz| with dalpha's two parts added and each
    transmittance T counted (1 + |log T|) times (a kernel that sums log T
    in f32 errs by a share of it), the scale against which a kernel's
    rounding is held."""
    return _backward(order, offsets, alpha, feat.abs(), g.abs(), gz.abs(),
                     points_per_pixel, 1.0)


def _backward(order, offsets, alpha, feat, g, gz, ppp, sign):
    N, C = feat.shape
    dev = feat.device
    npix = offsets.numel() - 1
    pid, rank, n, counts = _runs(order, offsets, N)
    # the composited fragments, a run's first ppp, as (pixel, rank) cells
    # of a dense (npix, ppp) table: the in-run sums are f64 sums along its
    # rows (a global cumsum's differences would carry the rounding of the
    # whole frame's sum into every pixel)
    keep = rank < ppp
    o, p, r = order[:pid.numel()][keep], pid[keep], rank[keep]
    a = alpha[o]
    la = torch.zeros((npix, ppp), dtype=torch.float64, device=dev)
    la[p, r] = torch.log1p(-a).double()
    lT = (torch.cumsum(la, 1) - la)[p, r]
    T = torch.exp(lT).float()
    if sign > 0:  # |terms|: a kernel sums log T in f32, one add a fragment
        T = T * (1 - lT).float()
    w = a * T
    dot = (g[p] * feat[n[keep]]).sum(-1)
    wd = torch.zeros_like(la)
    wd[p, r] = (w * dot).double()
    after = (torch.flip(torch.cumsum(torch.flip(wd, [1]), 1), [1])
             - wd)[p, r].float()
    dalpha = torch.zeros(alpha.shape, dtype=torch.float32, device=dev)
    dalpha[o] = T * dot + sign * (after / (1 - a))
    dfeat = torch.zeros((N, C), dtype=torch.float32, device=dev)
    dfeat.index_add_(0, n[keep], w[:, None] * g[p])
    dz = torch.zeros(N, dtype=torch.float32, device=dev)
    heads = offsets[:-1][counts > 0]
    dz.index_add_(0, order[heads] % N, gz[counts > 0])
    return dfeat, dalpha, dz


def composite_backward(order, offsets, alpha, feat, g, gz,
                       points_per_pixel=8):
    """The backward kernel for CUDA tensors (two launches), the plain
    version for CPU tensors -> dfeat (N,C), dalpha (K*N,), dz (N,)."""
    if not feat.is_cuda:
        return composite_backward_plain(order, offsets, alpha, feat, g, gz,
                                        points_per_pixel)
    name = "splat_composite_backward"
    N, C = feat.shape
    npix = offsets.numel() - 1
    kernels.check_cuda(name, order, offsets, alpha, feat, g, gz,
                       dtypes=(torch.int64, torch.int64) + (torch.float32,)
                       * 4)
    M = order.numel()
    if (alpha.numel() != M or N == 0 or M % N or tuple(g.shape) != (npix, C)
            or gz.numel() != npix):
        raise ValueError(f"{name}: bad shapes feat {tuple(feat.shape)} alpha "
                         f"{tuple(alpha.shape)} order {tuple(order.shape)} "
                         f"g {tuple(g.shape)} gz {tuple(gz.shape)}")
    align = 16 if C % 4 == 0 else 8 if C % 2 == 0 else 4  # its row loads
    if feat.data_ptr() % align or g.data_ptr() % align:
        raise ValueError(f"{name}: feat or g is not {align}-byte aligned")
    if M >= 2 ** 31 or npix >= 2 ** 31:
        raise ValueError(f"{name}: {M} fragments, {npix} pixels; the kernel "
                         "indexes them in 31 bits")
    if not 1 <= points_per_pixel <= BWD_PPP:
        raise ValueError(f"{name}: points_per_pixel {points_per_pixel}; the "
                         f"kernel takes 1 to {BWD_PPP} (a lane a fragment)")
    dev = feat.device
    frag = torch.empty((M, 4), dtype=torch.int32, device=dev)  # scratch
    dfeat = torch.empty((N, C), dtype=torch.float32, device=dev)
    dalpha = torch.empty((M,), dtype=torch.float32, device=dev)
    dz = torch.empty((N,), dtype=torch.float32, device=dev)
    kernels.launch(name, order.data_ptr(), offsets.data_ptr(),
                   alpha.data_ptr(), feat.data_ptr(), g.data_ptr(),
                   gz.data_ptr(), frag.data_ptr(), dfeat.data_ptr(),
                   dalpha.data_ptr(), dz.data_ptr(), npix, N, C, M // N,
                   points_per_pixel, kernels.stream_ptr(dev))
    return dfeat, dalpha, dz


class SplatComposite(torch.autograd.Function):
    """Kernel 4 (``composite``) with ``composite_backward`` as its VJP: the
    gradients of alpha, z and feat; the count has none."""

    @staticmethod
    def forward(ctx, order, offsets, alpha, z, feat, points_per_pixel):
        ctx.ppp = points_per_pixel
        ctx.save_for_backward(order, offsets, alpha, feat)
        out, zbuf, cnt = composite(order, offsets, alpha, z, feat,
                                   points_per_pixel)
        ctx.mark_non_differentiable(cnt)
        return out, zbuf, cnt

    @staticmethod
    def backward(ctx, g, gz, _):
        order, offsets, alpha, feat = ctx.saved_tensors
        npix = offsets.numel() - 1
        g = (feat.new_zeros((npix, feat.shape[1])) if g is None
             else g.float().contiguous())
        gz = feat.new_zeros(npix) if gz is None else gz.float().contiguous()
        dfeat, dalpha, dz = composite_backward(order, offsets, alpha, feat,
                                               g, gz, ctx.ppp)
        return None, None, dalpha, dz, dfeat, None


def composite(order, offsets, alpha, z, feat, points_per_pixel=8):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if not feat.is_cuda:
        return composite_plain(order, offsets, alpha, z, feat,
                               points_per_pixel)
    return composite_form(order, offsets, alpha, z, feat, "auto",
                          points_per_pixel)



def composite_form(order, offsets, alpha, z, feat, form="auto",
                   points_per_pixel=8):
    """The kernel on CUDA tensors in a chosen form (``FORMS``: "walk" holds
    at most ``WALK_C`` channels, "lanes" any); every form gives the same
    bits."""
    N, C = feat.shape
    npix = offsets.numel() - 1
    kernels.check_forward_only("splat_composite", alpha, z, feat)
    kernels.check_cuda("splat_composite", order, offsets, alpha, z, feat,
                       dtypes=(torch.int64, torch.int64, torch.float32,
                               torch.float32, torch.float32))
    if z.numel() != N or alpha.numel() != order.numel():
        raise ValueError(f"splat_composite: bad shapes feat {tuple(feat.shape)}"
                         f" z {tuple(z.shape)} alpha {tuple(alpha.shape)} "
                         f"order {tuple(order.shape)}")
    if order.numel() >= 2 ** 31:
        raise ValueError(f"splat_composite: {order.numel()} fragments; the "
                         "kernel indexes them in 32 bits (needs K*N < 2^31)")
    if form == "walk" and C > WALK_C:
        raise ValueError(f"splat_composite: the walk holds at most {WALK_C} "
                         f"channels, not {C}")
    dev = feat.device
    out = torch.empty((npix, C), dtype=torch.float32, device=dev)
    zbuf = torch.empty((npix,), dtype=torch.float32, device=dev)
    cnt = torch.empty((npix,), dtype=torch.float32, device=dev)
    kernels.launch("splat_composite", order.data_ptr(), offsets.data_ptr(),
                   alpha.data_ptr(), z.data_ptr(), feat.data_ptr(),
                   out.data_ptr(), zbuf.data_ptr(), cnt.data_ptr(), npix, N,
                   C, points_per_pixel, FORMS[form], kernels.stream_ptr(dev))
    return out, zbuf, cnt


def sort_fragments(points, intrinsics, H, W, radius_px=1.0,
                   pixel_center_offset=0.0):
    """Project and sort one image's fragments.  Returns the composite's
    inputs (order, offsets, alpha, Z)."""
    npix = H * W
    pid, alpha, Z = _project_fragments(points, intrinsics, H, W, radius_px,
                                       pixel_center_offset, npix)
    N = Z.shape[0]
    z_bits = 32 - int(npix + 1).bit_length()
    assert z_bits >= 8, "image too large for packed splat keys"
    key = (pid << z_bits) | _quantize_z(Z, z_bits).repeat(pid.numel() // N)
    key_s, order = torch.sort(key, stable=True)
    bounds = torch.arange(npix + 1, device=key.device) << z_bits
    offsets = torch.searchsorted(key_s, bounds)
    return order, offsets, alpha, Z


def splat_render(points, features, intrinsics, H: int, W: int,
                 radius_px: float = 1.0, points_per_pixel: int = 8,
                 pixel_center_offset: float = 0.0):
    """points (B,N,3), features (B,N,C), intrinsics (B,4) ->
    (B,H,W,C) composited features, (B,H,W) nearest-surface depth, both in
    the features' dtype; everything inside runs in f32.  Differentiable in
    the points and the features (``SplatComposite``) where autograd needs
    either; otherwise kernel 4's forward alone, which saves nothing."""
    grad = torch.is_grad_enabled() and (points.requires_grad
                                        or features.requires_grad)
    outs, zbufs = [], []
    for b in range(points.shape[0]):
        order, offsets, alpha, Z = sort_fragments(
            points[b].float(), intrinsics[b].float(), H, W, radius_px,
            pixel_center_offset)
        args = (order, offsets, alpha.contiguous(), Z.contiguous(),
                features[b].float().contiguous(), points_per_pixel)
        out, zbuf, _ = (SplatComposite.apply(*args) if grad
                        else composite(*args))
        outs.append(out.reshape(H, W, -1))
        zbufs.append(zbuf.reshape(H, W))
    dt = features.dtype
    return torch.stack(outs).to(dt), torch.stack(zbufs).to(dt)
