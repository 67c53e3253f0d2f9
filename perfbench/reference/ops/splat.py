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


__all__ = ["splat_render", "composite", "composite_plain"]


def _quantize_z(z, z_bits: int):
    """Top ``z_bits`` bits of the f32 encoding of z, as an unsigned code."""
    bits = z.detach().float().contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF
    return bits >> (32 - z_bits)


def _project_fragments(points, intrinsics, H, W, radius_px, npix_sentinel):
    """points (N,3) -> tap-major flat fragments (K*N,): pixel id (sentinel
    where culled), alpha; and the point depths Z (N,)."""
    R = int(math.ceil(radius_px))
    fx, fy, cx, cy = intrinsics.unbind(0)
    X, Y, Z = points.unbind(-1)
    zvalid = Z > 1e-4
    zs = torch.where(zvalid, Z, torch.ones_like(Z))
    x = fx * (X / zs) + cx
    y = fy * (Y / zs) + cy
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


def composite(order, offsets, alpha, z, feat, points_per_pixel=8):
    """What one launch of kernel 4 computes."""
    return composite_plain(order, offsets, alpha, z, feat,
                           points_per_pixel)


def sort_fragments(points, intrinsics, H, W, radius_px=1.0):
    """Project and sort one image's fragments.  Returns the composite's
    inputs (order, offsets, alpha, Z)."""
    npix = H * W
    pid, alpha, Z = _project_fragments(points, intrinsics, H, W, radius_px, npix)
    N = Z.shape[0]
    z_bits = 32 - int(npix + 1).bit_length()
    assert z_bits >= 8, "image too large for packed splat keys"
    key = (pid << z_bits) | _quantize_z(Z, z_bits).repeat(pid.numel() // N)
    key_s, order = torch.sort(key, stable=True)
    bounds = torch.arange(npix + 1, device=key.device) << z_bits
    offsets = torch.searchsorted(key_s, bounds)
    return order, offsets, alpha, Z


def splat_render(points, features, intrinsics, H: int, W: int,
                 radius_px: float = 1.0, points_per_pixel: int = 8):
    """points (B,N,3), features (B,N,C), intrinsics (B,4) ->
    (B,H,W,C) composited features, (B,H,W) nearest-surface depth, both in
    the features' dtype; everything inside runs in f32."""
    outs, zbufs = [], []
    for b in range(points.shape[0]):
        order, offsets, alpha, Z = sort_fragments(
            points[b].float(), intrinsics[b].float(), H, W, radius_px)
        args = (order, offsets, alpha.contiguous(), Z.contiguous(),
                features[b].float().contiguous(), points_per_pixel)
        out, zbuf, _ = composite(*args)
        outs.append(out.reshape(H, W, -1))
        zbufs.append(zbuf.reshape(H, W))
    dt = features.dtype
    return torch.stack(outs).to(dt), torch.stack(zbufs).to(dt)
