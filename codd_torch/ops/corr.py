"""Correlation pyramid and windowed lookup of RAFT-3D — kernels 2 and 6.

Counterpart of ``codd_tpu/ops/corr.py``.  Correlation is linear in f2, so
``avgpool^l(corr(f1, f2)) == corr(f1, avgpool^l(f2))`` and the pyramid is
built from pooled *features*: ``f1/4`` and ``avgpool^l(f2/4)``, each
rounded to bf16 after its own pool (``corr.py:73-80``), each level
zero-padded by 2r+1 so clamped window starts never clip.  Per GN
iteration and level, each query reads the t x t = 8 x 8 integer taps
around its target, masks queries whose window lies wholly outside the
level, and combines the taps bilinearly into (2r+1)^2 = 49 values.

Two layouts, as in ``codd_tpu`` (``corr_lookup`` dispatches on them):

* ``impl="volume"`` (a list of volumes; ``runtime.corr_impl`` ``auto``,
  ``volume``, ``volume_reduce``, ``volume_pallas``): per frame one padded
  correlation volume per level, ``vol_l = <f1, level_l>`` rounded to bf16
  from an f32-accumulated product (``corr.py:85-96``).  Kernel 2
  (``csrc/corr_lookup.cu``) replaces the slab gather, the TPU column
  select ``codd_tpu/ops/pallas/corr_select.py:window_select``
  (``pl.pallas_call`` at :60) and the bilinear combine of
  ``corr.py:152-205`` with one pass that reads the 64 taps straight from
  the bf16 volume.  Bound by bytes: per query 64 bf16 taps, 2 coords and
  49 f32 outputs (~340 B; 2.6 MB per level-0 call at 48x160).  One thread
  per (query, output row).
* ``impl="patch"`` (a dict ``{"f1", "levels"}``; ``runtime.corr_impl``
  ``patch``): no volume is built; every lookup recomputes the 64 tap dots
  of a query from the level's features.  Kernel 6
  (``csrc/corr_patch.cu``) replaces the prototype TPU kernel
  ``scripts/kernel_corr_pallas.py:corr_dots_pallas`` (``pl.pallas_call``
  at :73) and the window starts, patch gather, mask and combine of
  ``corr.py:103-134,208-246`` around it.  Bound by bytes: f1 (2 MB), one
  level (at most 3.7 MB), coords and 49 f32 outputs a query, each once;
  the 16 KB of taps a query re-reads come from L2.  One warp per query,
  8 channels a lane, fixed-order shuffle sums.  Forward only: it raises
  on a CUDA input that requires grad.

Both write their 49 values into the level's slice of the (B, h, w, L*49)
lookup.
"""

from __future__ import annotations

from typing import Dict, List, Union

import torch

from . import kernels

__all__ = ["build_corr_pyramid", "corr_lookup", "corr_lookup_level",
           "corr_lookup_level_plain", "corr_patch_lookup_level",
           "corr_patch_lookup_level_plain", "CORR_IMPLS"]

# runtime.corr_impl values; the three volume selects of codd_tpu are
# bit-identical there and are one lookup (kernel 2) here
CORR_IMPLS = ("auto", "volume", "volume_reduce", "volume_pallas", "patch")
Pyramid = Union[List[torch.Tensor], Dict[str, object]]


def _pool2(x):
    """2x2 sum-pool / 4 over (B,h,w,C), dropping odd edges (VALID)."""
    B, h, w, C = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :h2 * 2, :w2 * 2].reshape(B, h2, 2, w2, 2, C)
    return x.sum((2, 4)) / 4.0


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4, radius: int = 3,
                       impl: str = "volume") -> Pyramid:
    """fmap1/fmap2 (B,h,w,C) f32 -> the lookup state.

    ``impl="volume"``: per-level bf16 volumes (B, h*w, Hp, Wp) with
    Hp = hl + 2(2r+1), Wp = wl + 2(2r+1).  ``impl="patch"``:
    ``{"f1": (B, h*w, C) bf16, "levels": [(B, Hp, Wp, C) bf16 padded]}``.
    ``radius`` sets the padding and must match the lookup's."""
    if impl not in ("volume", "patch"):
        raise ValueError(f"bad corr pyramid impl {impl!r}")
    B, h, w, C = fmap1.shape
    P = 2 * radius + 1
    x = fmap2 / 4.0
    levels = [x.to(torch.bfloat16)]
    for _ in range(num_levels - 1):
        x = _pool2(x)
        levels.append(x.to(torch.bfloat16))
    levels = [torch.nn.functional.pad(f2_l, (0, 0, P, P, P, P))
              for f2_l in levels]
    f1 = (fmap1 / 4.0).to(torch.bfloat16).reshape(B, h * w, C)
    if impl == "patch":
        return {"f1": f1.contiguous(),
                "levels": [f2p.contiguous() for f2p in levels]}
    f1 = f1.float()
    vols = []
    for f2p in levels:
        Hp, Wp = f2p.shape[1:3]
        # bf16 operands are exact in f32: f32 products, f32 sums, one bf16
        # rounding of the result (the JAX preferred_element_type=f32 einsum)
        vol = torch.matmul(f1, f2p.reshape(B, Hp * Wp, C).float()
                           .transpose(1, 2))
        vols.append(vol.reshape(B, h * w, Hp, Wp).to(torch.bfloat16))
    return vols


def _window_starts(coords, hl, wl, radius):
    """Clamped padded-grid tap starts, bilinear fractions and window
    validity; coords (B,h,w,2) in level pixels."""
    B, h, w, _ = coords.shape
    r = radius
    P = 2 * r + 1
    cx = coords[..., 0].reshape(B, h * w)
    cy = coords[..., 1].reshape(B, h * w)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = (cx - x0)[:, :, None]
    fy = (cy - y0)[:, :, None]
    vq = ((x0 >= -(r + 1)) & (x0 <= wl - 1 + r)
          & (y0 >= -(r + 1)) & (y0 <= hl - 1 + r))
    sx = (x0.clamp(-(r + 1), wl - 1 + r) - r + P).long()
    sy = (y0.clamp(-(r + 1), hl - 1 + r) - r + P).long()
    return sy, sx, fy, fx, vq


def _bilinear_combine(dots, fy, fx, h, w):
    """(B,N,t,t) tap values -> (B,h,w,(t-1)^2) window values."""
    B, N, t, _ = dots.shape
    d00 = dots[:, :, :t - 1, :t - 1]
    d01 = dots[:, :, :t - 1, 1:]
    d10 = dots[:, :, 1:, :t - 1]
    d11 = dots[:, :, 1:, 1:]
    fx_ = fx[..., None]
    fy_ = fy[..., None]
    out = ((1 - fy_) * ((1 - fx_) * d00 + fx_ * d01)
           + fy_ * ((1 - fx_) * d10 + fx_ * d11))
    return out.reshape(B, h, w, (t - 1) * (t - 1))


def corr_lookup_level_plain(vol, coords, radius: int = 3):
    """vol (B,N,Hp,Wp) bf16; coords (B,h,w,2) in level pixels ->
    (B,h,w,(2r+1)^2) f32."""
    B, N, Hp, Wp = vol.shape
    h, w = coords.shape[1:3]
    t = 2 * radius + 2
    P = 2 * radius + 1
    sy, sx, fy, fx, vq = _window_starts(coords, Hp - 2 * P, Wp - 2 * P,
                                        radius)
    ar = torch.arange(t, device=vol.device)
    idx = ((sy[..., None, None] + ar[:, None]) * Wp
           + sx[..., None, None] + ar[None, :])               # (B,N,t,t)
    dots = torch.gather(vol.reshape(B, N, Hp * Wp), 2,
                        idx.reshape(B, N, t * t)).float()
    dots = dots.reshape(B, N, t, t) * vq[:, :, None, None]
    return _bilinear_combine(dots, fy, fx, h, w)


def _into(out, offset, res):
    """``res`` itself, or written into channels [offset, ...) of ``out``."""
    if out is None:
        return res
    out[..., offset:offset + res.shape[-1]] = res
    return out


def corr_lookup_level(vol, coords, radius: int = 3, scale: float = 1.0,
                      out=None, offset: int = 0):
    """One level's lookup at ``coords * scale``; the kernel for CUDA
    tensors (writing channels [offset, offset+49) of ``out`` when given),
    the plain version for CPU tensors."""
    if not vol.is_cuda:
        return _into(out, offset, corr_lookup_level_plain(
            vol, coords * scale, radius))
    B, N, Hp, Wp = vol.shape
    h, w = coords.shape[1:3]
    K = (2 * radius + 1) ** 2
    if out is None:
        out = torch.empty((B, h, w, K), dtype=torch.float32,
                          device=vol.device)
    kernels.check_cuda("corr_lookup", vol, coords, out,
                       dtypes=(torch.bfloat16, torch.float32, torch.float32))
    if (tuple(coords.shape) != (B, h, w, 2) or h * w != N
            or out.shape[:3] != (B, h, w) or offset + K > out.shape[-1]
            or radius > 3):
        raise ValueError(f"corr_lookup: bad shapes vol {tuple(vol.shape)} "
                         f"coords {tuple(coords.shape)} out "
                         f"{tuple(out.shape)} offset {offset} r {radius}")
    kernels.launch("corr_lookup", vol.data_ptr(), coords.data_ptr(),
                   out.data_ptr(), B, N, Hp, Wp, radius, float(scale),
                   out.shape[-1], offset, kernels.stream_ptr(vol.device))
    return out


def corr_patch_lookup_level_plain(f1, f2p, coords, radius: int = 3):
    """f1 (B,N,C) bf16, f2p (B,Hp,Wp,C) bf16 padded level, coords (B,h,w,2)
    in level pixels -> (B,h,w,(2r+1)^2) f32: the (t,t,C) patches gathered
    by index, f32 products summed over C, combined bilinearly."""
    B, Hp, Wp, C = f2p.shape
    N = f1.shape[1]
    h, w = coords.shape[1:3]
    t = 2 * radius + 2
    P = 2 * radius + 1
    sy, sx, fy, fx, vq = _window_starts(coords, Hp - 2 * P, Wp - 2 * P,
                                        radius)
    ar = torch.arange(t, device=f2p.device)
    idx = ((sy[..., None, None] + ar[:, None]) * Wp
           + sx[..., None, None] + ar[None, :]).reshape(B, N * t * t)
    patches = torch.gather(f2p.reshape(B, Hp * Wp, C), 1,
                           idx[..., None].expand(-1, -1, C))
    dots = (patches.reshape(B, N, t * t, C).float()
            * f1.float()[:, :, None, :]).sum(-1)
    dots = dots.reshape(B, N, t, t) * vq[:, :, None, None]
    return _bilinear_combine(dots, fy, fx, h, w)


def corr_patch_lookup_level(f1, f2p, coords, radius: int = 3,
                            scale: float = 1.0, out=None, offset: int = 0):
    """One level's patch lookup at ``coords * scale``; kernel 6 for CUDA
    tensors (writing channels [offset, offset+49) of ``out`` when given),
    the plain version for CPU tensors."""
    if not f2p.is_cuda:
        return _into(out, offset, corr_patch_lookup_level_plain(
            f1, f2p, coords * scale, radius))
    if f1.requires_grad or f2p.requires_grad or coords.requires_grad:
        raise NotImplementedError("corr_patch_lookup: forward only; the "
                                  "kernel has no backward yet")
    B, Hp, Wp, C = f2p.shape
    N = f1.shape[1]
    h, w = coords.shape[1:3]
    K = (2 * radius + 1) ** 2
    if out is None:
        out = torch.empty((B, h, w, K), dtype=torch.float32,
                          device=f2p.device)
    kernels.check_cuda("corr_patch_lookup", f1, f2p, coords, out,
                       dtypes=(torch.bfloat16, torch.bfloat16, torch.float32,
                               torch.float32))
    if (C != 128 or tuple(f1.shape) != (B, N, C)
            or tuple(coords.shape) != (B, h, w, 2) or h * w != N
            or out.shape[:3] != (B, h, w) or offset + K > out.shape[-1]
            or not 0 <= radius <= 3 or min(Hp, Wp) <= 2 * (2 * radius + 1)):
        raise ValueError(f"corr_patch_lookup: bad shapes f1 "
                         f"{tuple(f1.shape)} level {tuple(f2p.shape)} coords "
                         f"{tuple(coords.shape)} out {tuple(out.shape)} "
                         f"offset {offset} r {radius} (needs C == 128)")
    kernels.launch("corr_patch_lookup", f1.data_ptr(), f2p.data_ptr(),
                   coords.data_ptr(), out.data_ptr(), B, N, Hp, Wp, radius,
                   float(scale), out.shape[-1], offset,
                   kernels.stream_ptr(f2p.device))
    return out


def corr_lookup(pyramid: Pyramid, coords, radius: int = 3):
    """coords (B,h,w,2) in level-0 pixels -> (B,h,w,L*(2r+1)^2), level-major
    then window row-major (dy outer, dx inner).  Dispatches on the
    pyramid's layout: a list of volumes or a ``{"f1", "levels"}`` dict."""
    B, h, w, _ = coords.shape
    K = (2 * radius + 1) ** 2
    patch = isinstance(pyramid, dict)
    levels = pyramid["levels"] if patch else pyramid
    out = torch.empty((B, h, w, len(levels) * K), dtype=torch.float32,
                      device=coords.device)
    coords = coords.contiguous()
    for i, lvl in enumerate(levels):
        if patch:
            corr_patch_lookup_level(pyramid["f1"], lvl, coords, radius,
                                    1.0 / 2 ** i, out=out, offset=i * K)
        else:
            corr_lookup_level(lvl, coords, radius, 1.0 / 2 ** i, out=out,
                              offset=i * K)
    return out
