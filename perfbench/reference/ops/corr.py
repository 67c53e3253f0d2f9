"""Correlation pyramid and windowed lookup of RAFT-3D — kernel 2's plain
form (the volume layout, ``runtime.corr_impl`` ``auto`` in inference).
Counterpart of ``codd_tpu/ops/corr.py``.  Correlation is linear in f2, so
``avgpool^l(corr(f1, f2)) == corr(f1, avgpool^l(f2))`` and the pyramid is
built from pooled *features*: ``f1/4`` and ``avgpool^l(f2/4)``, each
rounded to bf16 after its own pool (``corr.py:73-80``), each level
zero-padded by 2r+1 so clamped window starts never clip; per level one
padded correlation volume ``vol_l = <f1, level_l>``, rounded to bf16 from
an f32-accumulated product (``corr.py:85-96``).  Per GN iteration and
level, each query reads the t x t = 8 x 8 integer taps around its
target, masks queries whose window lies wholly outside the level, and
combines the taps bilinearly into (2r+1)^2 = 49 values, written into the
level's slice of the (B, h, w, L*49) lookup."""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["build_corr_pyramid", "corr_lookup", "corr_lookup_levels",
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
    with Hp = hl + 2(2r+1), Wp = wl + 2(2r+1); ``radius`` sets the padding
    and must match the lookup's."""
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
    vols = []
    for f2p in levels:
        Hp, Wp = f2p.shape[1:3]
        # bf16 operands are exact in f32: f32 products, f32 sums, one bf16
        # rounding of the result (the JAX preferred_element_type=f32 einsum)
        vol = torch.matmul(f1.float(), f2p.reshape(B, Hp * Wp, C).float()
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
    """``res`` written into channels [offset, ...) of ``out``."""
    out[..., offset:offset + res.shape[-1]] = res
    return out


def corr_lookup_levels(vols: Sequence[torch.Tensor], coords, radius: int = 3):
    """Volumes ``vols`` (each (B,N,Hp,Wp) bf16) looked up at ``coords /
    2^i``, level i into channels [i*49, ...) of a (B,h,w,L*49) f32 output:
    what one launch of kernel 2 computes."""
    B, h, w = coords.shape[:3]
    K = (2 * radius + 1) ** 2
    out = torch.empty((B, h, w, len(vols) * K), dtype=torch.float32,
                      device=coords.device)
    for i, vol in enumerate(vols):
        _into(out, i * K, corr_lookup_level_plain(vol, coords * (1.0 / 2 ** i), radius))
    return out


def corr_lookup(vols: Sequence[torch.Tensor], coords, radius: int = 3):
    """coords (B,h,w,2) in level-0 pixels -> (B,h,w,L*(2r+1)^2), level-major
    then window row-major (dy outer, dx inner)."""
    return corr_lookup_levels(vols, coords.contiguous(), radius)
