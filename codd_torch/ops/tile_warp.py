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

Training: under grad mode, with an input that requires grad,
``tile_warp_cost`` goes through ``TileWarpCost``, a
``torch.autograd.Function`` whose backward is ``tile_warp_cost_backward``:
a second kernel of ``csrc/tile_warp.cu`` for CUDA tensors, and
``tile_warp_cost_backward_plain`` (the same math step by step, the
scatter to ``fea_r`` by ``index_add_``) for CPU tensors.  It computes the
VJP of ``tile_warping``: ``floor()`` has no gradient and ``|x|``'s
cotangent is JAX's ``select(x >= 0, g, -g)`` (+g at 0).  In bf16 (the
"exact" form; the "pallas" form has no VJP and raises) every step runs in
the dtypes ``jax.vjp`` gives it: each lerp cotangent rounded, the inner
taps' two cotangents added in bf16, each channel sum of ``df`` and the
tile sums of ``to_plane``'s transpose rounded after every add, so dhyp3
and dfea_l are ``jax.jit(jax.vjp(tile_warping))``'s bits.  dfea_r sums a
column's taps in f32 and rounds once; XLA's scatter-add rounds after each
add.

The backward kernel gives each image row one block (a cluster of four per
tile row): a pixel's taps lie on its own row, so the block owns the row of
``dfea_r``.  It sorts the row's pixels by their first tap (a stable
sort, so that each column sums its taps in one order at every launch:
pixel order within a bin; ranks taken in the order of shared-memory
atomics gave dfea_r other bits from launch to launch where an f32 sum
rounds to two bf16 values); then, for a
group of ``backward_channel_group`` channels at a time, each pixel packs
the signs of its L1 terms into shared memory and each column rebuilds and
sums the cotangents of the taps that read it and stores them once: no
atomics on floats, no zero fill.  Its bf16 form keeps that design and
takes each step as ``_backward_exact`` does, two channels an instruction
in native bf16x2 arithmetic (each such step rounds once, as the f32 step
rounded to bf16 does), with the channel sums of df kept in shared memory
across channel groups: every output but dfea_r has the plain version's
bits, and dfea_r sums each column's tap cotangents in f32 and rounds
once, as the plain version does, in another order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .upsample import pixel_unshuffle, plane_offsets, to_plane
from .warp import meshgrid_xy

__all__ = ["tile_warp_cost", "tile_warp_cost_plain", "TileWarpCost",
           "tile_warp_cost_backward", "tile_warp_cost_backward_plain",
           "tile_warp_cost_backward_terms",
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


def _taps_exact(hyp3, fea_r):
    """``tile_warping``'s taps in the features' dtype: the lerp fraction f
    (B,H,W,1), the taps' mask ok and their columns idx in the 3-column
    zero-padded row (B,H,W,4), and the masked taps cols (B,H,W,4,C)."""
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
    return f, ok, idx, cols * ok[..., None].to(fea_r.dtype)


def _cost_exact(hyp3, fea_l, fea_r):
    """``tile_warping`` in the features' dtype, step by step."""
    f, _, _, cols = _taps_exact(hyp3, fea_r)
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


def _abs_vjp(d, g):
    """The cotangent of ``|d|`` for ``g``: JAX's ``select(d >= 0, g, -g)``,
    so +g at 0 and -g at NaN."""
    return torch.where(d >= 0, g, -g)


def _backward_f32(g, hyp3, fea_l, fea_r):
    B, H, W, C = fea_r.shape
    f, ok, idx, cols = _taps_f32(hyp3, fea_r)
    gk = _pixel_shuffle(g, 4)                                   # (B,H,W,3)
    dfea_l = torch.zeros_like(fea_l)
    dcols = torch.zeros_like(cols)
    dlocal = torch.zeros_like(f[..., 0])
    for kk, j in enumerate((2, 1, 0)):
        warped = cols[..., j, :] * (1 - f) + cols[..., j + 1, :] * f
        e = _abs_vjp(fea_l - warped, gk[..., kk:kk + 1])
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


def _seq_sum(x, dim: int):
    """The sum over ``dim`` rounded after each add, in index order from +0:
    XLA's reduce of a bf16 array on the CPU."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _backward_exact(g, hyp3, fea_l, fea_r):
    """The VJP of ``tile_warping`` in bf16, step by step in the dtypes that
    ``jax.vjp`` gives it (each elementwise step rounded; each reduce over
    channels, tile rows and tile columns rounded after every add, in index
    order): dhyp3 and dfea_l are ``jax.jit(jax.vjp(tile_warping))``'s bits.
    The gather's transpose sums the taps of a ``fea_r`` column in f32 and
    rounds once, where XLA's scatter-add rounds after each add in pixel
    order (``tests/test_torch_train_bf16.py`` holds the difference)."""
    B, H, W, C = fea_r.shape
    dt, dev = fea_r.dtype, fea_r.device
    f, ok, idx, cols = _taps_exact(hyp3, fea_r)
    omf = 1 - f
    gk = _pixel_shuffle(g, 4)                                   # (B,H,W,3)
    e = []
    for kk, j in enumerate((2, 1, 0)):
        warped = cols[..., j, :] * omf + cols[..., j + 1, :] * f
        e.append(_abs_vjp(fea_l - warped, gk[..., kk:kk + 1]))
    dfea_l = (e[2] + e[1]) + e[0]
    # each lerp cotangent rounded; the inner taps add two of them in bf16
    a = [-ek * omf for ek in e]
    b = [-ek * f for ek in e]
    dcols = torch.stack([a[2], b[2] + a[1], b[1] + a[0], b[0]], -2) \
        * ok[..., None].to(dt)
    # into the 3-column zero-padded row, then its slice
    rows = (torch.arange(B * H, device=dev).reshape(B, H, 1, 1) * (W + 6)
            + idx).reshape(-1)
    acc = torch.zeros((B * H * (W + 6), C), dtype=torch.float32, device=dev)
    acc.index_add_(0, rows, dcols.float().reshape(-1, C))
    dfea_r = acc.reshape(B, H, W + 6, C)[:, :, 3:W + 3].to(dt)
    # df: per offset the channel sums of the (1 - f) and the f cotangent,
    # then added in the order of the transpose; dlocal_d = -df
    pa = [_seq_sum(-e[kk] * cols[..., j, :], -1)
          for kk, j in enumerate((2, 1, 0))]
    pb = [_seq_sum(-e[kk] * cols[..., j + 1, :], -1)
          for kk, j in enumerate((2, 1, 0))]
    v = pb[2] - pa[2]
    v = v + pb[1]
    v = v - pa[1]
    v = v + pb[0]
    v = v - pa[0]
    # to_plane's transpose: (d + a dx) + b dy over the tile's 4 x 4
    c = plane_offsets(4, dt, dev)
    t = (-v).reshape(B, H // 4, 4, W // 4, 4)                   # b, i, a, j
    r = _seq_sum(t, 2)                                          # by column
    q = _seq_sum(t, 4)                                          # by row
    dhyp3 = torch.stack([_seq_sum(r, 3), _seq_sum(r * c, 3),
                         _seq_sum(q * c[:, None], 2)], -1)
    return dhyp3, dfea_l, dfea_r


def tile_warp_cost_backward_terms(g, hyp3, fea_r):
    """For each element of the bf16 backward's dfea_r, the sum of the |tap
    cotangents| it adds and their count (f32): the scale of a bound on the
    order of its adds."""
    B, H, W, C = fea_r.shape
    f, ok, idx, _ = _taps_exact(hyp3, fea_r)
    gk = _pixel_shuffle(g, 4).float().abs()
    omf = (1 - f).float()
    f = f.float()
    a = [gk[..., kk:kk + 1] * omf for kk in range(3)]
    b = [gk[..., kk:kk + 1] * f for kk in range(3)]
    t = torch.stack([a[2], b[2] + a[1], b[1] + a[0], b[0]], -2) \
        * ok[..., None]                                         # (B,H,W,4,1)
    rows = (torch.arange(B * H, device=fea_r.device).reshape(B, H, 1, 1)
            * (W + 6) + idx).reshape(-1)
    out = []
    for v in (t, (t > 0).float()):
        acc = torch.zeros((B * H * (W + 6), 1), device=fea_r.device)
        acc.index_add_(0, rows, v.reshape(-1, 1))
        out.append(acc.reshape(B, H, W + 6, 1)[:, :, 3:W + 3].expand(
            B, H, W, C))
    return tuple(out)


def tile_warp_cost_backward_plain(g, hyp3, fea_l, fea_r):
    """The VJP of the cost (``"exact"`` form) at (hyp3, fea_l, fea_r) for
    the cotangent ``g`` (B,ht,wt,48) -> (dhyp3, dfea_l, dfea_r) in the
    features' dtype, step by step as ``csrc/tile_warp.cu``'s backward
    computes it."""
    form = _resolve_form(fea_r.dtype, "exact")
    if form == "f32":
        return _backward_f32(g, hyp3, fea_l, fea_r)
    return _backward_exact(g, hyp3, fea_l, fea_r)


def tile_warp_cost_backward(g, hyp3, fea_l, fea_r):
    """The backward kernel for CUDA tensors (f32, or bf16 in the "exact"
    form), the plain version for CPU tensors -> (dhyp3, dfea_l, dfea_r)."""
    if not fea_r.is_cuda:
        return tile_warp_cost_backward_plain(g, hyp3, fea_l, fea_r)
    B, H, W, C = fea_r.shape
    code = FORMS[_resolve_form(fea_r.dtype, "exact")]
    kernels.check_cuda("tile_warp_cost_backward", g, hyp3, fea_l, fea_r,
                       dtypes=(fea_r.dtype,) * 4)
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
                   B, H, W, C, cg, code, kernels.stream_ptr(fea_r.device))
    return dhyp3, dfea_l, dfea_r


class TileWarpCost(torch.autograd.Function):
    """The cost (f32, or bf16 in the "exact" form) with kernel 1's
    backward."""

    @staticmethod
    def forward(ctx, hyp3, fea_l, fea_r):
        ctx.save_for_backward(hyp3, fea_l, fea_r)
        if not fea_r.is_cuda:
            return tile_warp_cost_plain(hyp3, fea_l, fea_r, "exact")
        return _launch_forward(hyp3, fea_l, fea_r, "exact")

    @staticmethod
    def backward(ctx, g):
        return tile_warp_cost_backward(g.contiguous(), *ctx.saved_tensors)


def tile_warp_cost(hyp3, fea_l, fea_r, form: str = "exact"):
    """The kernel for CUDA tensors (in the dtype it is given: f32, or bf16
    in ``form``), the plain version for CPU tensors; through
    ``TileWarpCost`` when autograd needs its gradient (f32, or bf16 in the
    "exact" form: the "pallas" form has no VJP in ``codd_tpu``)."""
    if torch.is_grad_enabled() and (hyp3.requires_grad or fea_l.requires_grad
                                    or fea_r.requires_grad):
        if _resolve_form(fea_r.dtype, form) == "pallas":
            raise NotImplementedError(
                "tile_warp_cost: the bf16 \"pallas\" form has no backward "
                "(codd_tpu differentiates only tile_warping, the \"exact\" "
                "form)")
        return TileWarpCost.apply(hyp3, fea_l, fea_r)
    if not fea_r.is_cuda:
        return tile_warp_cost_plain(hyp3, fea_l, fea_r, form)
    return _launch_forward(hyp3, fea_l, fea_r, form)
