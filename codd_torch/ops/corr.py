"""Correlation pyramid and windowed lookup of RAFT-3D — kernels 2 and 6.

Counterpart of ``codd_tpu/ops/corr.py``.  Correlation is linear in f2, so
``avgpool^l(corr(f1, f2)) == corr(f1, avgpool^l(f2))`` and the pyramid is
built from pooled *features*: ``f1/4`` and ``avgpool^l(f2/4)``, each
rounded to bf16 after its own pool (``corr.py:73-80``), each level
zero-padded by 2r+1 so clamped window starts never clip.  Per GN
iteration and level, each query reads the t x t = 8 x 8 integer taps
around its target, masks queries whose window lies wholly outside the
level, and combines the taps bilinearly into (2r+1)^2 = 49 values.

Two layouts, as in ``codd_tpu`` (``corr_lookup`` dispatches on them), each
with one kernel that looks up every level of the pyramid in one launch
(``corr_lookup_levels`` / ``corr_patch_lookup_levels``; the per-level
functions launch it for one level):

* ``impl="volume"`` (a list of volumes; ``runtime.corr_impl`` ``auto``,
  ``volume``, ``volume_reduce``, ``volume_pallas``): per frame one padded
  correlation volume per level, ``vol_l = <f1, level_l>`` rounded to bf16
  from an f32-accumulated product (``corr.py:85-96``).  Kernel 2
  (``csrc/corr_lookup.cu``) replaces the slab gather, the TPU column
  select ``codd_tpu/ops/pallas/corr_select.py:window_select``
  (``pl.pallas_call`` at :60) and the bilinear combine of
  ``corr.py:152-205`` with one pass that reads the 64 taps straight from
  the bf16 volume.  Bound by bytes: per query and level 64 bf16 taps, 2
  coords and 49 f32 outputs (~340 B; 10 MB for the four levels at
  48x160).  One warp a query, a lane a tap row of one level, 16-byte
  loads.
* ``impl="patch"`` (a dict ``{"f1", "levels"}``; ``runtime.corr_impl``
  ``patch``): no volume is built; every lookup recomputes the 64 tap dots
  of a query from the level's features.  Kernel 6
  (``csrc/corr_patch.cu``) replaces the prototype TPU kernel
  ``scripts/kernel_corr_pallas.py:corr_dots_pallas`` (``pl.pallas_call``
  at :73) and the window starts, patch gather, mask and combine of
  ``corr.py:103-134,208-246`` around it.  Bound by bytes: f1 (2 MB), the
  levels, coords and 49 f32 outputs a query and level, each once.  A
  block takes ``PATCH_TILE`` queries of one level and stages the bounding
  box of their windows in shared memory when it fits in
  ``PATCH_BOX_BYTES``, else reads the taps from global memory
  (``patch_lookup_plan`` says which); one warp a query, fixed-order f32
  sums.

Both write their 49 values a level into the level's slice of the
(B, h, w, L*49) lookup.

Training takes the patch layout (``codd_tpu``'s ``corr_impl="auto"`` in
training, ``raft3d.py:227,258``).  Under autograd the patch lookup runs as
``CorrPatchLookup``, whose backward is ``csrc/corr_patch.cu``'s second
kernel: the VJP of ``codd_tpu/ops/corr.py:208-246 _lookup_level`` with
respect to ``f1``, the levels and the coordinates.  Per query and level
the 49 cotangents
go through the transpose of the bilinear combine to 8 x 8 tap cotangents
(0 for a masked query), then ``df1 += sum_taps dtap * level[tap]`` (the
query's own row: written in full, f32 sums rounded once to bf16) and
``dlevel[tap] += dtap * f1`` (a scatter into a zeroed f32 padded level,
rounded once to bf16).  The kernel takes the forward's tile and writes
both as products over the bounding box of its windows: with D (box pixel
x query) holding each query's tap cotangents at its window, ``dbox = D
F1`` and ``df1^T = box^T D`` run on the tensor cores, and each pixel of
the box meets one f32 ``atomicAdd`` a block, in chunks of
``PATCH_BWD_BOX_BYTES`` (``patch_lookup_plan(backward=True)`` says which
boxes take one).  The gradients come back in the
inputs' bf16, and ``build_corr_pyramid``'s casts carry them to f32, as in
``codd_tpu`` (``corr.py:73-80``); the padding's own backward crops them.
The coordinates carry a gradient where the depth they are projected from
trains (joint training with a trainable stereo; ``codd_tpu`` stops only
the SE(3) field): ``floor()`` has none, so per query and level
``d out / d fx = (1 - fy)(d01 - d00) + fy (d11 - d10)`` and
``d out / d fy = (1 - fx)(d10 - d00) + fx (d11 - d01)`` from the masked tap
dots d, and ``d coords = sum_levels scale_l sum_taps g . d out / d f``.
``corr_patch_lookup_coords_backward`` (``csrc/corr_patch.cu``'s third
entry) recomputes the dots on the forward's tile as one product on the
tensor cores, the tile's f1 rows against the box of their windows, staged
in chunks of ``PATCH_COORDS_BOX_BYTES`` (``patch_lookup_plan(coords_grad=
True)`` says which boxes take one), a block a tile and level; a second
kernel sums each query's levels in order: two floats a query, no
atomics.  It launches only where the coordinates require grad.  The volume lookup
(kernel 2) has no backward and raises wherever autograd would need it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Union

import torch

from . import kernels

__all__ = ["build_corr_pyramid", "corr_lookup", "corr_lookup_levels",
           "corr_lookup_level", "corr_lookup_level_plain",
           "corr_patch_lookup_levels", "corr_patch_lookup_level",
           "corr_patch_lookup_level_plain", "patch_lookup_plan", "CORR_IMPLS",
           "PATCH_TILE", "PATCH_BOX_BYTES", "PATCH_BWD_BOX_BYTES",
           "PATCH_COORDS_BOX_BYTES",
           "CorrPatchLookup",
           "corr_patch_lookup_backward", "corr_patch_lookup_backward_plain",
           "corr_patch_lookup_level_backward_plain",
           "corr_patch_lookup_coords_backward",
           "corr_patch_lookup_coords_backward_plain",
           "corr_patch_lookup_coords_backward_terms"]

# runtime.corr_impl values; the three volume selects of codd_tpu are
# bit-identical there and are one lookup (kernel 2) here
CORR_IMPLS = ("auto", "volume", "volume_reduce", "volume_pallas", "patch")
Pyramid = Union[List[torch.Tensor], Dict[str, object]]
# kernel 6: a block's queries (rows, columns), and the shared memory it may
# stage its window box in; 96 KB lets two blocks share an SM
PATCH_TILE = (4, 8)
PATCH_BOX_BYTES = 96 * 1024
# kernel 6's backward: the shared memory a block may stage a chunk of its
# box in, 320 bytes a pixel (its bf16 half pixel, 160, and its f32 row of
# D, 160); whole m-tiles of 16 pixels, at least one.  240 pixels a chunk
# let two blocks share an SM.
PATCH_BWD_BOX_BYTES = 75 * 1024
_BWD_PIXEL_BYTES = 320
# the coordinates' gradient: the shared memory a block may stage a chunk of
# its box in, 256 bytes a pixel, whole n-tiles of 8 pixels, at least one.
# 224 pixels a chunk let three blocks share an SM.
PATCH_COORDS_BOX_BYTES = 56 * 1024


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


def _scales(n, scales):
    return [1.0 / 2 ** i for i in range(n)] if scales is None else list(scales)


def _levels_args(levels, hw, scales):
    """The C arrays of a launch: level pointers, (Hp, Wp) pairs, scales."""
    n = len(levels)
    return ((ctypes.c_void_p * n)(*[l.data_ptr() for l in levels]),
            (ctypes.c_int * (2 * n))(*[d for pair in hw for d in pair]),
            (ctypes.c_float * n)(*scales))


def _check_levels(name, levels, coords, out, offset, radius, K):
    """Shapes shared by both kernels' wrappers; raises on what they do not
    take.  Every pointer a kernel loads 16 bytes from is 16-byte aligned."""
    B, h, w = coords.shape[:3]
    if (not 1 <= len(levels) <= 4 or not 0 <= radius <= 3
            or tuple(coords.shape) != (B, h, w, 2)
            or tuple(out.shape[:3]) != (B, h, w)
            or offset + len(levels) * K > out.shape[-1]):
        raise ValueError(f"{name}: bad shapes: {len(levels)} levels, coords "
                         f"{tuple(coords.shape)}, out {tuple(out.shape)}, "
                         f"offset {offset}, r {radius}")
    if any(l.data_ptr() % 16 for l in levels):
        raise ValueError(f"{name}: a level is not 16-byte aligned")


def corr_lookup_levels(vols: Sequence[torch.Tensor], coords, radius: int = 3,
                       scales=None, out=None, offset: int = 0):
    """Volumes ``vols`` (each (B,N,Hp,Wp) bf16) looked up at ``coords *
    scales[i]`` (default 1/2^i), level i into channels [offset + i*49, ...)
    of ``out`` (B,h,w,C) f32, which is made when not given: one launch of
    kernel 2 for CUDA tensors, the plain version level by level for CPU
    tensors."""
    B, h, w = coords.shape[:3]
    K = (2 * radius + 1) ** 2
    scales = _scales(len(vols), scales)
    # no backward, on either device
    kernels.check_forward_only("corr_lookup", *vols, coords)
    if out is None:
        out = torch.empty((B, h, w, len(vols) * K), dtype=torch.float32,
                          device=coords.device)
    if not vols[0].is_cuda:
        for i, (vol, sc) in enumerate(zip(vols, scales)):
            _into(out, offset + i * K,
                  corr_lookup_level_plain(vol, coords * sc, radius))
        return out
    kernels.check_cuda("corr_lookup", *vols, coords, out,
                       dtypes=(torch.bfloat16,) * len(vols)
                       + (torch.float32, torch.float32))
    _check_levels("corr_lookup", vols, coords, out, offset, radius, K)
    if any(tuple(v.shape[:2]) != (B, h * w) for v in vols):
        raise ValueError(f"corr_lookup: volumes {[tuple(v.shape) for v in vols]}"
                         f" do not match coords {tuple(coords.shape)}")
    ptrs, hw, sc = _levels_args(vols, [v.shape[2:] for v in vols], scales)
    kernels.launch("corr_lookup", ptrs, hw, sc, len(vols), coords.data_ptr(),
                   out.data_ptr(), B, h * w, radius, out.shape[-1], offset,
                   kernels.stream_ptr(coords.device))
    return out


def corr_lookup_level(vol, coords, radius: int = 3, scale: float = 1.0,
                      out=None, offset: int = 0):
    """One level's lookup at ``coords * scale``; the kernel for CUDA
    tensors (writing channels [offset, offset+49) of ``out`` when given),
    the plain version for CPU tensors."""
    return corr_lookup_levels([vol], coords, radius, [scale], out, offset)


def _tap_dots(f1, f2p, coords, radius):
    """The masked (B,N,t,t) tap dots of every query, f32 products summed
    over C, and its bilinear fractions fy, fx."""
    B, Hp, Wp, C = f2p.shape
    N = f1.shape[1]
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
    return dots.reshape(B, N, t, t) * vq[:, :, None, None], fy, fx


def corr_patch_lookup_level_plain(f1, f2p, coords, radius: int = 3):
    """f1 (B,N,C) bf16, f2p (B,Hp,Wp,C) bf16 padded level, coords (B,h,w,2)
    in level pixels -> (B,h,w,(2r+1)^2) f32: the (t,t,C) patches gathered
    by index, f32 products summed over C, combined bilinearly."""
    h, w = coords.shape[1:3]
    return _bilinear_combine(*_tap_dots(f1, f2p, coords, radius), h, w)


def _bilinear_transpose(g, fy, fx, t):
    """The VJP of ``_bilinear_combine``: (B,N,(t-1)^2) cotangents ->
    (B,N,t,t) tap cotangents, each corner's term added in the order d00,
    d01, d10, d11 (the kernel's order)."""
    B, N, _ = g.shape
    gg = g.reshape(B, N, t - 1, t - 1)
    fy_, fx_ = fy[..., None], fx[..., None]
    gy, gx = 1 - fy_, 1 - fx_
    dd = g.new_zeros((B, N, t, t))
    dd[:, :, :-1, :-1] += (gg * gy) * gx
    dd[:, :, :-1, 1:] += (gg * gy) * fx_
    dd[:, :, 1:, :-1] += (gg * fy_) * gx
    dd[:, :, 1:, 1:] += (gg * fy_) * fx_
    return dd


def _bilinear_coords(g, dots, fy, fx, sign=-1.0):
    """The VJP of ``_bilinear_combine`` with respect to its fractions:
    (B,N,(t-1)^2) cotangents and (B,N,t,t) tap values -> (B,N,2), the
    derivatives with respect to (fx, fy); ``sign=1`` adds the corners'
    terms instead (their |terms| on |g| and |dots|)."""
    B, N, t, _ = dots.shape
    gg = g.reshape(B, N, t - 1, t - 1)
    d00, d01 = dots[:, :, :-1, :-1], dots[:, :, :-1, 1:]
    d10, d11 = dots[:, :, 1:, :-1], dots[:, :, 1:, 1:]
    fx_, fy_ = fx[..., None], fy[..., None]
    dfx = (1 - fy_) * (d01 + sign * d00) + fy_ * (d11 + sign * d10)
    dfy = (1 - fx_) * (d10 + sign * d00) + fx_ * (d11 + sign * d01)
    return torch.stack([(gg * dfx).sum((2, 3)), (gg * dfy).sum((2, 3))], -1)


def corr_patch_lookup_level_backward_plain(g, f1, f2p, coords,
                                           radius: int = 3):
    """The VJP of ``corr_patch_lookup_level_plain`` at (f1, f2p) for the
    cotangent g (B,h,w,(2r+1)^2) -> (df1 (B,N,C), df2p (B,Hp,Wp,C)), both
    f32: the bilinear transpose, the vq mask, then the gather's dots
    against the patches and the scatter-add of dtap * f1 into the padded
    level.  The coordinates' gradient is
    ``corr_patch_lookup_coords_backward_plain``'s."""
    B, Hp, Wp, C = f2p.shape
    N = f1.shape[1]
    t = 2 * radius + 2
    P = 2 * radius + 1
    sy, sx, fy, fx, vq = _window_starts(coords, Hp - 2 * P, Wp - 2 * P,
                                        radius)
    dd = _bilinear_transpose(g.reshape(B, N, -1).float(), fy, fx, t)
    dd = (dd * vq[:, :, None, None]).reshape(B, N * t * t)
    ar = torch.arange(t, device=f2p.device)
    idx = ((sy[..., None, None] + ar[:, None]) * Wp
           + sx[..., None, None] + ar[None, :]).reshape(B, N * t * t)
    patches = torch.gather(f2p.reshape(B, Hp * Wp, C), 1,
                           idx[..., None].expand(-1, -1, C)).float()
    df1 = torch.einsum("bnk,bnkc->bnc", dd.reshape(B, N, t * t),
                       patches.reshape(B, N, t * t, C))
    rows = (torch.arange(B, device=idx.device)[:, None] * (Hp * Wp)
            + idx).reshape(-1)
    terms = (dd.reshape(B, N, t * t, 1) * f1.float()[:, :, None, :])
    df2p = torch.zeros((B * Hp * Wp, C), dtype=torch.float32,
                       device=f2p.device)
    df2p.index_add_(0, rows, terms.reshape(-1, C))
    return df1, df2p.reshape(B, Hp, Wp, C)


def _coords_backward(g, f1, levels, coords, radius, scales, sign):
    """Each level's masked tap dots against the bilinear weights'
    derivatives (``floor()`` has none), times its scale, in level order."""
    K = (2 * radius + 1) ** 2
    dc = 0.0
    for i, (f2p, sc) in enumerate(zip(levels, _scales(len(levels), scales))):
        d = _bilinear_coords(
            g[..., i * K:(i + 1) * K].reshape(g.shape[0], -1, K).float(),
            *_tap_dots(f1, f2p, coords * sc, radius), sign)
        dc = dc + sc * d.reshape(coords.shape)
    return dc


def corr_patch_lookup_coords_backward_plain(g, f1, levels, coords,
                                            radius: int = 3, scales=None):
    """The VJP of ``corr_patch_lookup_levels`` with respect to ``coords``
    for the cotangent g (B,h,w,L*(2r+1)^2) -> (B,h,w,2) f32: level by
    level at ``coords * scale``, each level's gradient times its scale,
    summed in level order."""
    return _coords_backward(g, f1, levels, coords, radius, scales, -1.0)


def corr_patch_lookup_coords_backward_terms(g, f1, levels, coords,
                                            radius: int = 3, scales=None):
    """Each coordinate gradient's sum of |terms|: the plain version on |g|,
    |f1| and |levels| with the corners' terms added, the scale against
    which a kernel's rounding is held."""
    return _coords_backward(g.abs(), f1.abs(), [l.abs() for l in levels],
                            coords, radius, scales, 1.0)


def corr_patch_lookup_coords_backward(g, f1, levels, coords, radius: int = 3,
                                      scales=None):
    """The coordinates' gradient: one launch of its kernels (a block a tile
    and level, then the sum over levels) for CUDA tensors, the plain
    version for CPU tensors -> (B,h,w,2) f32."""
    levels = list(levels)
    if not levels[0].is_cuda:
        return corr_patch_lookup_coords_backward_plain(g, f1, levels, coords,
                                                       radius, scales)
    B, h, w = coords.shape[:3]
    K = (2 * radius + 1) ** 2
    name = "corr_patch_lookup_coords_backward"
    kernels.check_cuda(name, g, f1, *levels, coords,
                       dtypes=(torch.float32,) + (torch.bfloat16,)
                       * (1 + len(levels)) + (torch.float32,))
    _check_levels(name, levels, coords, g, 0, radius, K)
    P = 2 * radius + 1
    if (g.shape[-1] != len(levels) * K
            or tuple(f1.shape) != (B, h * w, 128) or f1.data_ptr() % 16
            or any(l.dim() != 4 or l.shape[0] != B or l.shape[3] != 128
                   or min(l.shape[1:3]) <= 2 * P for l in levels)):
        raise ValueError(f"{name}: bad shapes g {tuple(g.shape)} f1 "
                         f"{tuple(f1.shape)} levels "
                         f"{[tuple(l.shape) for l in levels]}")
    dc = torch.empty((B, h, w, 2), dtype=torch.float32, device=g.device)
    # scratch: each level's gradients, summed in level order by the launch
    part = torch.empty((len(levels), B * h * w, 2), dtype=torch.float32,
                       device=g.device)
    ptrs, hw, sc = _levels_args(levels, [l.shape[1:3] for l in levels],
                                _scales(len(levels), scales))
    kernels.launch(name, f1.data_ptr(), ptrs, hw, sc, len(levels),
                   coords.data_ptr(), g.data_ptr(), dc.data_ptr(),
                   part.data_ptr(), B, h, w, radius, PATCH_COORDS_BOX_BYTES,
                   kernels.stream_ptr(g.device))
    return dc


def corr_patch_lookup_backward_plain(g, f1, levels, coords, radius: int = 3,
                                     scales=None):
    """The VJP of ``corr_patch_lookup_levels`` (``out`` made by it) for the
    cotangent g (B,h,w,L*(2r+1)^2) -> (df1, [dlevel]) in the inputs' dtype:
    f32 sums, each rounded once."""
    K = (2 * radius + 1) ** 2
    df1, dlevels = 0.0, []
    for i, (f2p, sc) in enumerate(zip(levels, _scales(len(levels), scales))):
        d1, dl = corr_patch_lookup_level_backward_plain(
            g[..., i * K:(i + 1) * K], f1, f2p, coords * sc, radius)
        df1 = df1 + d1
        dlevels.append(dl.to(f2p.dtype))
    return df1.to(f1.dtype), dlevels


def corr_patch_lookup_backward(g, f1, levels, coords, radius: int = 3,
                               scales=None):
    """Kernel 6's backward for CUDA tensors (one launch, every level), the
    plain version for CPU tensors -> (df1, [dlevel]), bf16."""
    levels = list(levels)
    if not levels[0].is_cuda:
        return corr_patch_lookup_backward_plain(g, f1, levels, coords,
                                                radius, scales)
    B, h, w = coords.shape[:3]
    K = (2 * radius + 1) ** 2
    name = "corr_patch_lookup_backward"
    kernels.check_cuda(name, g, f1, *levels, coords,
                       dtypes=(torch.float32,) + (torch.bfloat16,)
                       * (1 + len(levels)) + (torch.float32,))
    _check_levels(name, levels, coords, g, 0, radius, K)
    if (g.shape[-1] != len(levels) * K
            or tuple(f1.shape) != (B, h * w, 128) or f1.data_ptr() % 16
            or any(l.dim() != 4 or l.shape[0] != B or l.shape[3] != 128
                   for l in levels)):
        raise ValueError(f"{name}: bad shapes g {tuple(g.shape)} f1 "
                         f"{tuple(f1.shape)} levels "
                         f"{[tuple(l.shape) for l in levels]}")
    dl32 = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
            for l in levels]
    df1 = torch.empty_like(f1)
    ptrs, hw, sc = _levels_args(levels, [l.shape[1:3] for l in levels],
                                _scales(len(levels), scales))
    grads = (ctypes.c_void_p * len(levels))(*[d.data_ptr() for d in dl32])
    kernels.launch(name, f1.data_ptr(), ptrs, hw, sc, len(levels),
                   coords.data_ptr(), g.data_ptr(), df1.data_ptr(), grads,
                   B, h, w, radius, PATCH_BWD_BOX_BYTES,
                   kernels.stream_ptr(coords.device))
    return df1, [d.to(l.dtype) for d, l in zip(dl32, levels)]


class CorrPatchLookup(torch.autograd.Function):
    """The four-level patch lookup with kernel 6's backward, and the
    coordinates' gradient where they require it."""

    @staticmethod
    def forward(ctx, coords, radius, scales, f1, *levels):
        ctx.radius, ctx.scales = radius, scales
        ctx.save_for_backward(coords, f1, *levels)
        return corr_patch_lookup_levels(f1, levels, coords, radius, scales)

    @staticmethod
    def backward(ctx, g):
        coords, f1, *levels = ctx.saved_tensors
        g = g.contiguous()
        df1, dlevels = corr_patch_lookup_backward(
            g, f1, levels, coords, ctx.radius, ctx.scales)
        dc = (corr_patch_lookup_coords_backward(g, f1, levels, coords,
                                                ctx.radius, ctx.scales)
              if ctx.needs_input_grad[0] else None)
        return (dc, None, None, df1, *dlevels)


def patch_lookup_plan(coords, level_shapes, radius: int = 3, scales=None,
                      box_bytes=None, backward: bool = False,
                      coords_grad: bool = False):
    """Which blocks of kernel 6 stage their window box in shared memory
    (True) and which read their taps from global memory (False), by the
    kernel's own rule.  A block takes ``PATCH_TILE`` queries of one level;
    its box spans the window starts (sx, sy) of those of its queries whose
    window touches the level, plus t = 2r+2 taps, a box row takes
    bw * 256 + 16 bytes, and it stages when its bh rows fit in
    ``box_bytes`` (default ``PATCH_BOX_BYTES``).  With ``backward`` the
    rule of the backward kernel, which stages every box, in chunks: True
    where the box is one chunk, bw * bh pixels at 320 bytes within
    ``box_bytes`` (default ``PATCH_BWD_BOX_BYTES``; at least 16 pixels).
    With ``coords_grad`` the rule of the coordinates' gradient, which also
    stages every box in chunks: True where the box is one chunk, bw * bh
    pixels at 256 bytes within ``box_bytes`` (default
    ``PATCH_COORDS_BOX_BYTES``; whole n-tiles of 8 pixels, at least one).
    A block none of whose windows touches the level reads nothing and
    counts as staged.  ``level_shapes``: (Hp, Wp) of each padded level.
    Returns (L, B, tiles_y, tiles_x) bool."""
    if box_bytes is None:
        box_bytes = (PATCH_BWD_BOX_BYTES if backward else
                     PATCH_COORDS_BOX_BYTES if coords_grad else
                     PATCH_BOX_BYTES)
    B, h, w, _ = coords.shape
    th, tw = PATCH_TILE
    ny, nx = -(-h // th), -(-w // tw)
    t, P = 2 * radius + 2, 2 * radius + 1
    plans = []
    for (Hp, Wp), sc in zip(level_shapes, _scales(len(level_shapes), scales)):
        sy, sx, _, _, vq = _window_starts(coords * sc, Hp - 2 * P, Wp - 2 * P,
                                          radius)

        def tiles(v, fill):   # (B, h*w) -> (B, ny, nx, th*tw), padded
            full = torch.full((B, ny * th, nx * tw), fill, dtype=torch.long,
                              device=coords.device)
            full[:, :h, :w] = v.reshape(B, h, w)
            return (full.reshape(B, ny, th, nx, tw).permute(0, 1, 3, 2, 4)
                    .reshape(B, ny, nx, th * tw))

        big = 2 ** 40
        x_lo = tiles(torch.where(vq, sx, big), big).amin(-1)
        y_lo = tiles(torch.where(vq, sy, big), big).amin(-1)
        x_hi = tiles(torch.where(vq, sx, -1), -1).amax(-1)
        y_hi = tiles(torch.where(vq, sy, -1), -1).amax(-1)
        touched = x_hi >= 0
        bw, bh = x_hi - x_lo + t, y_hi - y_lo + t
        if backward:   # a chunk: whole m-tiles of 16 pixels, at least one
            fits = bw * bh <= max(16, box_bytes // _BWD_PIXEL_BYTES // 16 * 16)
        elif coords_grad:  # a chunk: whole n-tiles of 8 pixels, at least one
            fits = bw * bh <= max(8, box_bytes // 256 // 8 * 8)
        else:
            fits = (bw * 256 + 16) * bh <= box_bytes
        plans.append(~touched | fits)
    return torch.stack(plans)


def corr_patch_lookup_levels(f1, levels: Sequence[torch.Tensor], coords,
                             radius: int = 3, scales=None, out=None,
                             offset: int = 0):
    """Padded feature levels ``levels`` (each (B,Hp,Wp,128) bf16) looked up
    for ``f1`` (B,N,128) bf16 at ``coords * scales[i]`` (default 1/2^i),
    level i into channels [offset + i*49, ...) of ``out`` (B,h,w,C) f32,
    which is made when not given: one launch of kernel 6 for CUDA tensors,
    the plain version level by level for CPU tensors; through
    ``CorrPatchLookup`` when autograd needs the gradient of ``f1``, a
    level or the coordinates."""
    B, h, w = coords.shape[:3]
    K = (2 * radius + 1) ** 2
    scales = _scales(len(levels), scales)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (f1, coords, *levels)):
        if out is not None or offset:
            raise NotImplementedError("corr_patch_lookup: under autograd "
                                      "the lookup makes its own output")
        return CorrPatchLookup.apply(coords, radius, scales, f1, *levels)
    if out is None:
        out = torch.empty((B, h, w, len(levels) * K), dtype=torch.float32,
                          device=coords.device)
    if not levels[0].is_cuda:
        for i, (f2p, sc) in enumerate(zip(levels, scales)):
            _into(out, offset + i * K,
                  corr_patch_lookup_level_plain(f1, f2p, coords * sc, radius))
        return out
    kernels.check_cuda("corr_patch_lookup", f1, *levels, coords, out,
                       dtypes=(torch.bfloat16,) * (1 + len(levels))
                       + (torch.float32, torch.float32))
    _check_levels("corr_patch_lookup", levels, coords, out, offset, radius,
                  K)
    P = 2 * radius + 1
    if (tuple(f1.shape) != (B, h * w, 128) or f1.data_ptr() % 16
            or any(l.dim() != 4 or l.shape[0] != B or l.shape[3] != 128
                   or min(l.shape[1:3]) <= 2 * P for l in levels)):
        raise ValueError(f"corr_patch_lookup: bad shapes f1 "
                         f"{tuple(f1.shape)} levels "
                         f"{[tuple(l.shape) for l in levels]} coords "
                         f"{tuple(coords.shape)} (needs C == 128 and f1 "
                         "16-byte aligned)")
    ptrs, hw, sc = _levels_args(levels, [l.shape[1:3] for l in levels],
                                scales)
    kernels.launch("corr_patch_lookup", f1.data_ptr(), ptrs, hw, sc,
                   len(levels), coords.data_ptr(), out.data_ptr(), B, h, w,
                   radius, out.shape[-1], offset, PATCH_BOX_BYTES,
                   kernels.stream_ptr(coords.device))
    return out


def corr_patch_lookup_level(f1, f2p, coords, radius: int = 3,
                            scale: float = 1.0, out=None, offset: int = 0):
    """One level's patch lookup at ``coords * scale``; kernel 6 for CUDA
    tensors (writing channels [offset, offset+49) of ``out`` when given),
    the plain version for CPU tensors."""
    return corr_patch_lookup_levels(f1, [f2p], coords, radius, [scale], out,
                                    offset)


def corr_lookup(pyramid: Pyramid, coords, radius: int = 3):
    """coords (B,h,w,2) in level-0 pixels -> (B,h,w,L*(2r+1)^2), level-major
    then window row-major (dy outer, dx inner), in one launch.  Dispatches
    on the pyramid's layout: a list of volumes or a ``{"f1", "levels"}``
    dict."""
    coords = coords.contiguous()
    if isinstance(pyramid, dict):
        return corr_patch_lookup_levels(pyramid["f1"], pyramid["levels"],
                                        coords, radius)
    return corr_lookup_levels(pyramid, coords, radius)
