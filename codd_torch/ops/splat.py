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
"""

from __future__ import annotations

import math

import torch

from . import kernels

__all__ = ["splat_render", "composite", "composite_plain"]

WALK_C = 8  # channels the walk holds in registers (csrc/splat_composite.cu)
# the kernel's forms, by the launcher's code ("auto" chooses by C)
FORMS = {"auto": 0, "walk": 1, "lanes": 2}


def _quantize_z(z, z_bits: int):
    """Top ``z_bits`` bits of the f32 encoding of z, as an unsigned code."""
    bits = z.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
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


def composite_plain(order, offsets, alpha, z, feat, points_per_pixel=8):
    """order (M,) int64 fragment ids sorted by (pixel, z); offsets (npix+1,)
    int64 run starts; alpha (M,) f32 per fragment id (tap-major, point id
    = fragment id % N); z (N,), feat (N,C) f32.
    Returns out (npix,C), zbuf (npix,), count (npix,) f32."""
    N, C = feat.shape
    npix = offsets.numel() - 1
    counts = offsets[1:] - offsets[:-1]
    Mr = int(offsets[-1])
    dev = feat.device
    o = order[:Mr]
    n = o % N
    a = alpha[o]
    pid = torch.repeat_interleave(torch.arange(npix, device=dev), counts)
    rank = torch.arange(Mr, device=dev) - offsets[:-1][pid]
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
    the features' dtype; everything inside runs in f32."""
    outs, zbufs = [], []
    for b in range(points.shape[0]):
        order, offsets, alpha, Z = sort_fragments(
            points[b].float(), intrinsics[b].float(), H, W, radius_px,
            pixel_center_offset)
        out, zbuf, _ = composite(order, offsets, alpha, Z.contiguous(),
                                 features[b].float().contiguous(),
                                 points_per_pixel)
        outs.append(out.reshape(H, W, -1))
        zbufs.append(zbuf.reshape(H, W))
    dt = features.dtype
    return torch.stack(outs).to(dt), torch.stack(zbufs).to(dt)
