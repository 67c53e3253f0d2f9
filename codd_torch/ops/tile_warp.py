"""Slant-plane tile-warp cost of HITNet propagation — kernel 1.

For each 4x4 tile with hypothesis (d, dx, dy) the right features are warped
along the tile's slant plane at the offsets k in {-1, 0, +1}; the L1
distance to the left features, PixelUnshuffled(4), gives a (B, ht, wt, 48)
cost with channel ``k*16 + i*4 + j``.  Out-of-image taps read zero.

Replaces the TPU kernel ``codd_tpu/ops/pallas/tile_warp.py:tile_warp_cost``
(``pl.pallas_call`` at :123); its XLA oracle, and the function
``tile_warp_cost_plain`` below computes, is
``codd_tpu/models/stereo/hitnet.py:tile_warping``.

On the H100 (``csrc/tile_warp.cu``): one thread per pixel.  The work is
~24 flops per channel per pixel against (2C+3/16)*4 bytes read, so the
kernel is bound by bytes: 69 MB at the full-res call (384x1280, C=16), a
20 us floor at 3.35 TB/s.  The design reads each left feature once, the
four right taps as plain global loads (they sit up to ``max_disp``
columns away on the same row, which L1/L2 serve), and never materialises
the warped features the XLA path gathers into device memory.  The plane
and lerp arithmetic uses round-to-nearest intrinsics so that no FMA
contraction moves ``floor()`` off the plain version.

Under bf16 features the function has two forms, as in ``codd_tpu``:

* ``"exact"`` (``tile_warp_variant`` ``auto`` / ``exact``, and the
  approximations ``tilewin`` / ``grouped``, which the port does not
  reproduce): ``tile_warping`` run in bf16.  Every elementwise step
  rounds to bf16: the plane offsets are ``jnp.linspace``'s bf16 values
  (-0.49609375 for -0.5), the x grid is a bf16 ``arange`` (above x = 512
  the columns round to multiples of 4, above 1024 to multiples of 8), the
  4-column block starts at ``clip(round(round(x0 - 1) + 3), 0, W + 2)`` in
  the 3-column zero-padded row (its taps masked by ``x0 - 1 + m`` in
  [0, W - 1], computed exactly), and the channel sum of the L1 costs runs
  in f32 with one rounding, as ``jnp.sum`` upcasts.  On the CPU this is
  bit for bit ``jax.jit(tile_warping)`` (``tests/test_torch_bf16.py``).
* ``"pallas"``: the f32 body on the widened inputs (exact), only the
  output rounded to bf16, as ``ops/pallas/tile_warp.py`` computes.

Both read and write bf16 (half the bytes of the f32 form); the kernel is
one body templated on the form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .upsample import pixel_unshuffle, to_plane
from .warp import meshgrid_xy

__all__ = ["tile_warp_cost", "tile_warp_cost_plain", "FORMS",
           "VARIANT_FORMS"]

# the launcher's form codes: f32, and the two bf16 forms
FORMS = {"f32": 0, "exact": 1, "pallas": 2}
# runtime.tile_warp_variant -> the bf16 form it selects
VARIANT_FORMS = {"auto": "exact", "exact": "exact", "tilewin": "exact",
                 "grouped": "exact", "pallas": "pallas"}


def _resolve_form(dtype, form: str) -> str:
    if form not in ("exact", "pallas"):
        raise ValueError(f"tile_warp_cost: form {form!r}, one of "
                         "'exact', 'pallas'")
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return form
    raise TypeError(f"tile_warp_cost: features of dtype {dtype}; the "
                    "kernel takes float32 or bfloat16")


def _cost_f32(hyp3, fea_l, fea_r):
    B, H, W, C = fea_r.shape
    local_d = to_plane(hyp3[..., 0], hyp3[..., 1], hyp3[..., 2], size=4)
    x, _ = meshgrid_xy(H, W, fea_r.dtype, fea_r.device)
    p = x[None] - local_d
    x0 = torch.floor(p)
    f = (p - x0)[..., None]
    taps = x0[..., None] - 1 + torch.arange(4, dtype=p.dtype, device=p.device)
    ok = (taps >= 0) & (taps <= W - 1)
    idx = taps.clamp(0, W - 1).long()                           # (B,H,W,4)
    cols = torch.gather(fea_r, 2, idx.reshape(B, H, W * 4, 1).expand(
        -1, -1, -1, C)).reshape(B, H, W, 4, C)
    cols = cols * ok[..., None].to(fea_r.dtype)
    cvs = []
    # k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
    for j in (2, 1, 0):
        warped = cols[..., j, :] * (1 - f) + cols[..., j + 1, :] * f
        cv = torch.sum(torch.abs(fea_l - warped), -1, keepdim=True)
        cvs.append(pixel_unshuffle(cv, 4))
    return torch.cat(cvs, -1)


def _cost_exact(hyp3, fea_l, fea_r):
    """``tile_warping`` in the features' dtype, step by step."""
    B, H, W, C = fea_r.shape
    local_d = to_plane(hyp3[..., 0], hyp3[..., 1], hyp3[..., 2], size=4)
    x, _ = meshgrid_xy(H, W, fea_r.dtype, fea_r.device)
    p = x[None] - local_d
    x0 = torch.floor(p)
    f = (p - x0)[..., None]
    # the 4-column block of the 3-column zero-padded row starts at
    # x0 - 1 + 3, both sums rounded; the taps' mask sees x0 - 1 + m exact
    # (XLA keeps that f32 sum unrounded)
    start = (x0 - 1 + 3).clamp(0, W + 2).long().clamp_(max=W + 2)
    ar = torch.arange(4, device=p.device)
    idx = start[..., None] + ar                                 # (B,H,W,4)
    cols = torch.gather(F.pad(fea_r, (0, 0, 3, 3)), 2, idx.reshape(
        B, H, W * 4, 1).expand(-1, -1, -1, C)).reshape(B, H, W, 4, C)
    taps = x0.float()[..., None] - 1 + ar
    ok = (taps >= 0) & (taps <= W - 1)
    cols = cols * ok[..., None].to(fea_r.dtype)
    cvs = []
    for j in (2, 1, 0):
        warped = cols[..., j, :] * (1 - f) + cols[..., j + 1, :] * f
        cv = torch.abs(fea_l - warped).float().sum(-1, keepdim=True)
        cvs.append(pixel_unshuffle(cv.to(fea_r.dtype), 4))
    return torch.cat(cvs, -1)


def tile_warp_cost_plain(hyp3, fea_l, fea_r, form: str = "exact"):
    """hyp3 (B,ht,wt,3), fea_l/fea_r (B,H,W,C) -> (B,ht,wt,48) in the
    features' dtype.  ``form`` selects the bf16 form ("exact" or
    "pallas"); f32 features have one."""
    form = _resolve_form(fea_r.dtype, form)
    if form == "f32":
        return _cost_f32(hyp3, fea_l, fea_r)
    if form == "pallas":
        return _cost_f32(hyp3.float(), fea_l.float(),
                         fea_r.float()).to(fea_r.dtype)
    return _cost_exact(hyp3, fea_l, fea_r)


def tile_warp_cost(hyp3, fea_l, fea_r, form: str = "exact"):
    """The kernel for CUDA tensors (in the dtype it is given: f32, or bf16
    in ``form``), the plain version for CPU tensors."""
    if not fea_r.is_cuda:
        return tile_warp_cost_plain(hyp3, fea_l, fea_r, form)
    B, H, W, C = fea_r.shape
    ht, wt = H // 4, W // 4
    code = FORMS[_resolve_form(fea_r.dtype, form)]
    kernels.check_cuda("tile_warp_cost", hyp3, fea_l, fea_r,
                       dtypes=(fea_r.dtype,) * 3)
    if (H % 4 or W % 4 or C % 4 or tuple(fea_l.shape) != (B, H, W, C)
            or tuple(hyp3.shape) != (B, ht, wt, 3)):
        raise ValueError(f"tile_warp_cost: bad shapes hyp3 {tuple(hyp3.shape)}"
                         f" fea_l {tuple(fea_l.shape)} fea_r {(B, H, W, C)}")
    out = torch.empty((B, ht, wt, 48), dtype=fea_r.dtype,
                      device=fea_r.device)
    kernels.launch("tile_warp_cost", hyp3.data_ptr(), fea_l.data_ptr(),
                   fea_r.data_ptr(), out.data_ptr(), B, H, W, C, code,
                   kernels.stream_ptr(fea_r.device))
    return out
