"""Correlation pyramid and windowed lookup of RAFT-3D — kernel 2.

Counterpart of ``codd_tpu/ops/corr.py`` on its inference path
(``impl="volume"`` pyramid, ``select="reduce"`` lookup).  Per frame the
pyramid holds one padded correlation volume per level,
``vol_l = <f1/4, avgpool^l(f2/4)>`` over the f2 grid zero-padded by 2r+1,
rounded to bf16 from an f32-accumulated product (``corr.py:73-96``).  Per
GN iteration and level, each query reads the t x t = 8 x 8 integer taps
around its target, masks queries whose window lies wholly outside the
level, and combines the taps bilinearly into (2r+1)^2 = 49 values.

The kernel (``csrc/corr_lookup.cu``) replaces the slab gather, the TPU
column select ``codd_tpu/ops/pallas/corr_select.py:window_select``
(``pl.pallas_call`` at :60) and the bilinear combine of
``corr.py:152-205`` with one pass that reads the 64 taps straight from the
bf16 volume and writes its 49 values into the (B, h, w, L*49) lookup.  On
the H100 it is bound by bytes: per query it needs 64 bf16 taps, 2 coords
and 49 f32 outputs (~340 B; 2.6 MB per level-0 call at 48x160), which the
kernel reads once, against the 2*N*t*Wp bytes of slabs the XLA path
gathers into device memory.  One thread per (query, output row): seven
threads share a query and write 49 consecutive floats.
"""

from __future__ import annotations

from typing import List

import torch

from . import kernels

__all__ = ["build_corr_pyramid", "corr_lookup", "corr_lookup_level",
           "corr_lookup_level_plain"]


def _pool2(x):
    """2x2 sum-pool / 4 over (B,h,w,C), dropping odd edges (VALID)."""
    B, h, w, C = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :h2 * 2, :w2 * 2].reshape(B, h2, 2, w2, 2, C)
    return x.sum((2, 4)) / 4.0


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4,
                       radius: int = 3) -> List[torch.Tensor]:
    """fmap1/fmap2 (B,h,w,C) f32 -> per-level bf16 volumes (B, h*w, Hp, Wp)
    with Hp = hl + 2(2r+1), Wp = wl + 2(2r+1)."""
    B, h, w, C = fmap1.shape
    P = 2 * radius + 1
    x = fmap2 / 4.0
    levels = [x.to(torch.bfloat16)]
    for _ in range(num_levels - 1):
        x = _pool2(x)
        levels.append(x.to(torch.bfloat16))
    f1 = (fmap1 / 4.0).to(torch.bfloat16).reshape(B, h * w, C).float()
    vols = []
    for f2_l in levels:
        f2p = torch.nn.functional.pad(f2_l, (0, 0, P, P, P, P))
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


def corr_lookup_level(vol, coords, radius: int = 3, scale: float = 1.0,
                      out=None, offset: int = 0):
    """One level's lookup at ``coords * scale``; the kernel for CUDA
    tensors (writing channels [offset, offset+49) of ``out`` when given),
    the plain version for CPU tensors."""
    if not vol.is_cuda:
        res = corr_lookup_level_plain(vol, coords * scale, radius)
        if out is None:
            return res
        out[..., offset:offset + res.shape[-1]] = res
        return out
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


def corr_lookup(vols: List[torch.Tensor], coords, radius: int = 3):
    """coords (B,h,w,2) in level-0 pixels -> (B,h,w,L*(2r+1)^2), level-major
    then window row-major (dy outer, dx inner)."""
    B, h, w, _ = coords.shape
    K = (2 * radius + 1) ** 2
    out = torch.empty((B, h, w, len(vols) * K), dtype=torch.float32,
                      device=coords.device)
    coords = coords.contiguous()
    for i, vol in enumerate(vols):
        corr_lookup_level(vol, coords, radius, 1.0 / 2 ** i, out=out,
                          offset=i * K)
    return out
