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
  The kernel runs each channel's lerp and ``|l - w|`` as native bf16x2
  operations, which give the same bits as the f32 step rounded to bf16
  (``tests/test_torch_tile_warp.py::test_bf16_ops_round_once``).
* ``"pallas"``: the f32 body on the widened inputs (exact), only the
  output rounded to bf16, as ``ops/pallas/tile_warp.py`` computes.

Both read and write bf16 (half the bytes of the f32 form); the kernel is
one body templated on the form.

Training (f32 only): under grad mode, with an input that requires grad,
``tile_warp_cost`` goes through ``TileWarpCost``, a
``torch.autograd.Function`` whose backward is ``tile_warp_cost_backward``:
a second kernel of ``csrc/tile_warp.cu`` for CUDA tensors, and
``tile_warp_cost_backward_plain`` (the same math step by step, the
scatter to ``fea_r`` by ``index_add_``) for CPU tensors.  It computes the
VJP of ``tile_warping``: ``floor()`` has no gradient and ``|x|``'s is
``sign(x)``, 0 at 0, as in JAX.  bf16 training raises.

The backward kernel gives each image row one block (a cluster of four per
tile row): a pixel's taps lie on its own row, so the block owns the row of
``dfea_r``.  It sorts the row's pixels by their first tap; then, for a
group of ``backward_channel_group`` channels at a time, each pixel packs
the signs of its L1 terms into shared memory and each column rebuilds and
sums the cotangents of the taps that read it and stores them once: no
atomics on floats, no zero fill.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .upsample import pixel_unshuffle, plane_offsets, to_plane
from .warp import meshgrid_xy

__all__ = ["tile_warp_cost", "tile_warp_cost_plain", "TileWarpCost",
           "tile_warp_cost_backward", "tile_warp_cost_backward_plain",
           "backward_channel_group", "BWD_ROW_BYTES", "FORMS",
           "VARIANT_FORMS"]

# the launcher's form codes: f32, and the two bf16 forms
FORMS = {"f32": 0, "exact": 1, "pallas": 2}
# runtime.tile_warp_variant -> the bf16 form it selects
VARIANT_FORMS = {"auto": "exact", "exact": "exact", "tilewin": "exact",
                 "grouped": "exact", "pallas": "pallas"}


# the shared memory (bytes) the backward's row block may give the packed
# signs of one channel group, W x cg bytes (2 bits a channel and offset):
# every channel in one group at the main path's widths (1280 x 16: 20 KB)
BWD_ROW_BYTES = 32 * 1024


def backward_channel_group(W: int, C: int, budget: int = None) -> int:
    """The channels a pass of the backward kernel's row block takes: the
    largest multiple of 4 that divides C whose W x cg bytes of packed signs
    fit ``budget`` (default ``BWD_ROW_BYTES``)."""
    budget = BWD_ROW_BYTES if budget is None else budget
    fits = [cg for cg in range(4, C + 1, 4) if C % cg == 0 and W * cg <= budget]
    if not fits:
        raise ValueError(f"tile_warp_cost_backward: a row of width {W} "
                         f"does not fit {budget} bytes of shared memory "
                         "four channels at a time")
    return fits[-1]


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


def _taps_f32(hyp3, fea_r):
    """Each pixel's four right-feature taps, out-of-image ones zero: the
    lerp fraction f (B,H,W,1), ok and the tap columns idx (B,H,W,4), and
    cols (B,H,W,4,C)."""
    B, H, W, C = fea_r.shape
    local_d = to_plane(hyp3[..., 0], hyp3[..., 1], hyp3[..., 2], size=4)
    x, _ = meshgrid_xy(H, W, fea_r.dtype, fea_r.device)
    p = x[None] - local_d
    x0 = torch.floor(p)
    taps = x0[..., None] - 1 + torch.arange(4, dtype=p.dtype, device=p.device)
    ok = (taps >= 0) & (taps <= W - 1)
    # out-of-image (and NaN) taps read column 0, masked below
    idx = torch.where(ok, taps, torch.zeros_like(taps)).long()
    cols = torch.gather(fea_r, 2, idx.reshape(B, H, W * 4, 1).expand(
        -1, -1, -1, C)).reshape(B, H, W, 4, C)
    return (p - x0)[..., None], ok, idx, cols * ok[..., None].to(fea_r.dtype)


def _cost_f32(hyp3, fea_l, fea_r):
    f, _, _, cols = _taps_f32(hyp3, fea_r)
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


def _check_shapes(name, hyp3, fea_l, fea_r):
    B, H, W, C = fea_r.shape
    if (H % 4 or W % 4 or C % 4 or tuple(fea_l.shape) != (B, H, W, C)
            or tuple(hyp3.shape) != (B, H // 4, W // 4, 3)):
        raise ValueError(f"{name}: bad shapes hyp3 {tuple(hyp3.shape)}"
                         f" fea_l {tuple(fea_l.shape)} fea_r {(B, H, W, C)}")


def _launch_forward(hyp3, fea_l, fea_r, form):
    B, H, W, C = fea_r.shape
    code = FORMS[_resolve_form(fea_r.dtype, form)]
    kernels.check_cuda("tile_warp_cost", hyp3, fea_l, fea_r,
                       dtypes=(fea_r.dtype,) * 3)
    _check_shapes("tile_warp_cost", hyp3, fea_l, fea_r)
    out = torch.empty((B, H // 4, W // 4, 48), dtype=fea_r.dtype,
                      device=fea_r.device)
    kernels.launch("tile_warp_cost", hyp3.data_ptr(), fea_l.data_ptr(),
                   fea_r.data_ptr(), out.data_ptr(), B, H, W, C, code,
                   kernels.stream_ptr(fea_r.device))
    return out


def _pixel_shuffle(x, factor: int):
    """Inverse of ``pixel_unshuffle``: (B,h,w,C*f*f) -> (B,h*f,w*f,C)."""
    B, h, w, Cff = x.shape
    f = factor
    C = Cff // (f * f)
    x = x.reshape(B, h, w, C, f, f).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, h * f, w * f, C)


def tile_warp_cost_backward_plain(g, hyp3, fea_l, fea_r):
    """The VJP of the f32 cost at (hyp3, fea_l, fea_r) for the cotangent
    ``g`` (B,ht,wt,48) -> (dhyp3, dfea_l, dfea_r), step by step as
    ``csrc/tile_warp.cu``'s backward computes it."""
    B, H, W, C = fea_r.shape
    f, ok, idx, cols = _taps_f32(hyp3, fea_r)
    gk = _pixel_shuffle(g, 4)                                   # (B,H,W,3)
    dfea_l = torch.zeros_like(fea_l)
    dcols = torch.zeros_like(cols)
    dlocal = torch.zeros_like(f[..., 0])
    for kk, j in enumerate((2, 1, 0)):
        warped = cols[..., j, :] * (1 - f) + cols[..., j + 1, :] * f
        e = gk[..., kk:kk + 1] * torch.sign(fea_l - warped)
        dfea_l += e
        dcols[..., j, :] -= e * (1 - f)
        dcols[..., j + 1, :] -= e * f
        dlocal += torch.sum(e * (cols[..., j + 1, :] - cols[..., j, :]), -1)
    dcols = dcols * ok[..., None].to(fea_r.dtype)
    rows = (torch.arange(B * H, device=idx.device).reshape(B, H, 1, 1) * W
            + idx).reshape(-1)
    dfea_r = torch.zeros((B * H * W, C), dtype=fea_r.dtype,
                         device=fea_r.device)
    dfea_r.index_add_(0, rows, dcols.reshape(-1, C))
    # local_d = d + a dx + b dy, a along x and b along y of the tile
    c = plane_offsets(4, f.dtype, f.device)
    t = dlocal.reshape(B, H // 4, 4, W // 4, 4)                 # b, i, a, j
    dhyp3 = torch.stack([t.sum((2, 4)), (t * c).sum((2, 4)),
                         (t * c[:, None, None]).sum((2, 4))], -1)
    return dhyp3, dfea_l, dfea_r.reshape(B, H, W, C)


def tile_warp_cost_backward(g, hyp3, fea_l, fea_r):
    """The backward kernel for CUDA tensors (f32), the plain version for
    CPU tensors -> (dhyp3, dfea_l, dfea_r)."""
    if not fea_r.is_cuda:
        return tile_warp_cost_backward_plain(g, hyp3, fea_l, fea_r)
    B, H, W, C = fea_r.shape
    kernels.check_cuda("tile_warp_cost_backward", g, hyp3, fea_l, fea_r,
                       dtypes=(torch.float32,) * 4)
    _check_shapes("tile_warp_cost_backward", hyp3, fea_l, fea_r)
    if tuple(g.shape) != (B, H // 4, W // 4, 48):
        raise ValueError(f"tile_warp_cost_backward: g {tuple(g.shape)}")
    cg = backward_channel_group(W, C)
    dhyp3 = torch.empty_like(hyp3)
    dfea_l = torch.empty_like(fea_l)
    dfea_r = torch.empty_like(fea_r)
    kernels.launch("tile_warp_cost_backward", hyp3.data_ptr(),
                   fea_l.data_ptr(), fea_r.data_ptr(), g.data_ptr(),
                   dhyp3.data_ptr(), dfea_l.data_ptr(), dfea_r.data_ptr(),
                   B, H, W, C, cg, kernels.stream_ptr(fea_r.device))
    return dhyp3, dfea_l, dfea_r


class TileWarpCost(torch.autograd.Function):
    """The f32 cost with kernel 1's backward."""

    @staticmethod
    def forward(ctx, hyp3, fea_l, fea_r):
        ctx.save_for_backward(hyp3, fea_l, fea_r)
        if not fea_r.is_cuda:
            return _cost_f32(hyp3, fea_l, fea_r)
        return _launch_forward(hyp3, fea_l, fea_r, "exact")

    @staticmethod
    def backward(ctx, g):
        return tile_warp_cost_backward(g.contiguous(), *ctx.saved_tensors)


def tile_warp_cost(hyp3, fea_l, fea_r, form: str = "exact"):
    """The kernel for CUDA tensors (in the dtype it is given: f32, or bf16
    in ``form``), the plain version for CPU tensors; through
    ``TileWarpCost`` when autograd needs its gradient (f32 only)."""
    if torch.is_grad_enabled() and (hyp3.requires_grad or fea_l.requires_grad
                                    or fea_r.requires_grad):
        if fea_r.dtype != torch.float32:
            raise NotImplementedError(
                f"tile_warp_cost: the backward takes float32 features, got "
                f"{fea_r.dtype} (bf16 training is not ported yet)")
        return TileWarpCost.apply(hyp3, fea_l, fea_r)
    if not fea_r.is_cuda:
        return tile_warp_cost_plain(hyp3, fea_l, fea_r, form)
    return _launch_forward(hyp3, fea_l, fea_r, form)
