"""Smoke run of the codd_torch port on one CUDA card.

    python3 chip_smoke.py                 # every phase, the whole check
    python3 chip_smoke.py --phases kernels --steps 1   # a shorter check

Phases, in order:
  1. the card: ``torch.cuda.get_device_name(0)`` and nvidia-smi's name and
     power limit;
  2. build: every CUDA kernel of codd_torch/csrc, compiled by nvcc from the
     checkout's sources;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     seeded inputs at the largest call site of the 384x1280 streaming path,
     with its error, its time and the plain version's (CUDA events), and
     the least time the card could take (bytes over 3.35 TB/s or
     operations over the peak for their type, whichever is larger); the
     two GN kernels also at embedding scale 1.0, f32 and bf16 scores, twice
     for equal bits, with their time over that bound and the pairs their
     tiling evaluates for each useful one; the two corr lookups as the
     model calls them, four levels in one launch (equal in bits to one
     launch a level), on a smooth and a scattered coordinate field, with
     the share of the patch lookup's blocks that stage their window box in
     shared memory, and grid_sample's time beside the volume lookup's;
     the splat compositor at both call sites of the motion module (full
     res C=6 r=1, the row's time; quarter res 96x320 C=32 r=2, its time
     and bound as extra fields of the row) and at C=8, each form of it
     timed and equal in bits to the one chosen, with the run lengths and
     sort_fragments' time (projection, torch.sort, searchsorted) beside;
     kernel 1 also in its two bf16 forms ("exact", "pallas") against
     their plain bf16 versions, each timed beside the f32 form;
  4. main path: CODD from configs/models/codd.py (max_disp 320, 16 GN
     iterations, fusion width 32) with seeded random weights on the card,
     ``first_step`` and ``--steps`` ``step`` calls at 384x1280, B=1, with
     the launch count of every kernel, ms/frame and peak memory; then the
     splat compositor's forms on the last step's own two inputs;
  5. eval: the dataset evaluation path, ``run_inference(evaluate=True)``
     over an in-memory dataset of 2 synthetic sequences x 4 frames at
     384x1280 with exact ground truth, with ``runtime = {gn_impl:
     "pallas_window", corr_impl: "patch"}`` (kernels 5 and 6 in place of
     3 and 2), its metric table, ms per sequence and launch counts, and
     the main path's stream in that configuration beside phase 4's; then
     one sequence each through GTMotion + GTFusion, Motion + KalmanFusion
     and the stereo-only configs/models/stereo.py;
  6. plain: one frame pair at full width through the plain versions on
     the card, for the default and for the eval phase's configuration,
     the fused disparity held against the kernel run's, with the share of
     moved pixels at each stage of the cascade and the first that moved;
     then the default model in bf16 the same way, reported and not gated
     (at random weights bf16 is chaotic).
  bench: ``codd_torch/tools/bench.py`` in this process at 384x1280, a few
     calls each, f32, ``--bf16`` and ``--bf16 --batch 2``: each run's
     lines (ms a call, stream ms, launches a call, peak memory, the card)
     and its JSON line; the launches a call must be the main path's.
  profile (not in the default phases): one step of each configuration,
     and of the default one in bf16, under torch.profiler, split by
     category into chiprun_out/profile_step*.txt; both configurations
     streamed in turns.

Any failure exits non-zero.  The line before the last holds the kernel
table as JSON; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside the repository, it exits 1 and prints no
result.  Imports torch and codd_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 in the tensor cores
H, W = 384, 1280


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device ms per call of ``fn``, by CUDA events around ``iters`` calls.
    A spin kernel (~50 ms) holds the stream first, so the host has queued
    every launch before the first one runs and a kernel shorter than its
    Python launch is timed on the device, not at the host's launch rate.
    A ``fn`` that synchronises (a plain version reading a size back) still
    includes its host time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _compare(name, got, ref, atol, rtol):
    """Max abs error; fails where |got - ref| > atol + rtol * |ref|.
    ``atol`` is a number or a tensor of ``ref``'s shape."""
    import torch
    if isinstance(got, (tuple, list)):
        errs = [_compare(f"{name}[{i}]", g, r, atol, rtol)
                for i, (g, r) in enumerate(zip(got, ref))]
        return max(errs)
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err, max_ref = float(err.max()), float(ref.abs().max())
    shown = "per element" if torch.is_tensor(atol) else f"{atol:g}"
    print(f"  {name}: max_abs_err {max_err:.3e}  max|ref| {max_ref:.3e}  "
          f"rel {max_err / max(max_ref, 1e-30):.3e}  out of tol "
          f"{int(bad.sum())}/{bad.numel()} (atol {shown} + rtol {rtol:g}*|ref|)")
    if bool(bad.any()):
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


def corr_fields(noise, h8, w8, dev):
    """The lookups' two coordinate fields at 1/8 resolution: "scattered",
    the grid plus ``noise`` (i.i.d. N(0, 6^2) px), and "smooth", the grid
    plus a bilinearly upsampled (6, 20) field of +-8 px plus 0.25 px of
    jitter, seeded on its own (coherent, as the main path's targets are)."""
    import torch
    g = torch.Generator().manual_seed(5)
    ys, xs = torch.meshgrid(torch.arange(h8), torch.arange(w8), indexing="ij")
    grid = torch.stack([xs, ys], -1)[None].float().to(dev)
    coarse = torch.rand((1, 2, 6, 20), generator=g) * 16 - 8
    flow = torch.nn.functional.interpolate(
        coarse, size=(h8, w8), mode="bilinear", align_corners=False)
    smooth = (flow.permute(0, 2, 3, 1)
              + torch.randn((1, h8, w8, 2), generator=g) * 0.25)
    return {"smooth": (grid + smooth.to(dev)).contiguous(),
            "scattered": (grid + noise).contiguous()}


def _four_levels_equal(name, fn_all, fn_one, n_levels, K=49):
    """The four-level launch against one launch a level: equal bits."""
    import torch
    got = fn_all()
    per = torch.empty_like(got)
    for i in range(n_levels):
        fn_one(i, per, i * K)
    torch.cuda.synchronize()
    if not torch.equal(got, per):
        fail(f"{name}: the four-level launch differs from four one-level "
             "launches")


def corr_volume_check(vols, fields):
    """Kernel 2 on both fields against the plain version; its time, bound
    and the nearest library call: grid_sample on each bf16 volume viewed as
    (B*N, 1, Hp, Wp) at the query's 7 x 7 window points (align_corners,
    zero padding; bf16 output), one call a level, timed alone."""
    import torch
    from codd_torch.ops import corr
    errs, ms = [], {}
    for fname, c in fields.items():
        got = corr.corr_lookup(vols, c, 3)
        ref = torch.cat([corr.corr_lookup_level_plain(v, c / 2 ** i, 3)
                         for i, v in enumerate(vols)], -1)
        torch.cuda.synchronize()
        # the same bf16 taps and the same bilinear arithmetic order
        errs.append(_compare(f"corr_lookup ({fname})", got, ref, 1e-5, 1e-6))
        _four_levels_equal(
            "corr_lookup", lambda: corr.corr_lookup(vols, c, 3),
            lambda i, out, off: corr.corr_lookup_level(
                vols[i], c, 3, 1.0 / 2 ** i, out=out, offset=off), len(vols))
        ms[fname] = cuda_ms(lambda: corr.corr_lookup(vols, c, 3))
    coords = fields["smooth"]
    plain_ms = cuda_ms(lambda: [corr.corr_lookup_level_plain(
        v, coords / 2 ** i, 3) for i, v in enumerate(vols)])
    B, N = vols[0].shape[:2]
    d = torch.arange(-3, 4, device=coords.device, dtype=torch.float32)
    lib = []
    for i, v in enumerate(vols):
        Hp, Wp = v.shape[2:]
        c = coords.reshape(B * N, 1, 1, 2) / 2 ** i + 7.0  # padded grid
        pts = torch.stack(torch.broadcast_tensors(
            c[..., 0] + d[None, None, :], c[..., 1] + d[None, :, None]), -1)
        grid = (2 * pts / torch.tensor([Wp - 1.0, Hp - 1.0],
                                       device=coords.device) - 1
                ).to(torch.bfloat16)
        img = v.reshape(B * N, 1, Hp, Wp)
        lib.append(cuda_ms(lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)))
    print(f"  corr_lookup, four levels in one launch: smooth {ms['smooth']:.4f}"
          f" ms, scattered {ms['scattered']:.4f} ms; library (grid_sample, "
          f"bf16 out) {sum(lib):.4f} ms = "
          f"{' + '.join('%.4f' % t for t in lib)} by level")
    return dict(
        name="corr_lookup", source="codd_torch/csrc/corr_lookup.cu",
        replaces="codd_tpu/ops/pallas/corr_select.py:60",
        max_abs_err=max(errs), ms=ms["smooth"], plain_ms=plain_ms,
        # per query: 64 bf16 taps and 49 f32 outputs a level, 2 coords
        bytes=float(N * (len(vols) * (64 * 2 + 49 * 4) + 2 * 4)),
        flops=len(vols) * N * 49 * 9, library_ms=sum(lib))


def corr_patch_check(pyr, fields):
    """Kernel 6 on both fields against the plain version, with the share
    of its blocks that stage their window box in shared memory."""
    import torch
    from codd_torch.ops import corr
    errs, ms = [], {}
    shapes = [tuple(l.shape[1:3]) for l in pyr["levels"]]
    for fname, c in fields.items():
        got = corr.corr_lookup(pyr, c, 3)
        ref = torch.cat([corr.corr_patch_lookup_level_plain(
            pyr["f1"], l, c / 2 ** i, 3) for i, l in enumerate(pyr["levels"])],
            -1)
        torch.cuda.synchronize()
        # 128 exact bf16 x bf16 products summed in f32 in another order
        # than torch.sum's: a few ulps of sum |f1 . f2| ~ 128 * |f1| |f2|
        errs.append(_compare(f"corr_patch_lookup ({fname})", got, ref, 2e-5,
                             1e-5))
        _four_levels_equal(
            "corr_patch_lookup", lambda: corr.corr_lookup(pyr, c, 3),
            lambda i, out, off: corr.corr_patch_lookup_level(
                pyr["f1"], pyr["levels"][i], c, 3, 1.0 / 2 ** i, out=out,
                offset=off), len(shapes))
        ms[fname] = cuda_ms(lambda: corr.corr_lookup(pyr, c, 3))
        plan = corr.patch_lookup_plan(c, shapes, 3)
        share = [round(float(p.float().mean()), 3) for p in plan]
        print(f"  corr_patch_lookup ({fname}): four levels in one launch "
              f"{ms[fname]:.4f} ms; blocks staged in shared memory by level "
              f"{share} (of {plan[0].numel()} a level, box budget "
              f"{corr.PATCH_BOX_BYTES} B)")
    coords = fields["smooth"]
    plain_ms = cuda_ms(lambda: [corr.corr_patch_lookup_level_plain(
        pyr["f1"], l, coords / 2 ** i, 3) for i, l in enumerate(pyr["levels"])])
    N = pyr["f1"].shape[1]
    L = len(shapes)
    return dict(
        name="corr_patch_lookup", source="codd_torch/csrc/corr_patch.cu",
        replaces="scripts/kernel_corr_pallas.py:73", max_abs_err=max(errs),
        ms=ms["smooth"], plain_ms=plain_ms,
        # f1, every level, coords, each read once; 49 f32 outputs a level
        bytes=float(pyr["f1"].numel() * 2
                    + sum(l.numel() * 2 for l in pyr["levels"])
                    + N * (2 * 4 + L * 49 * 4)),
        flops=L * N * (64 * 256 + 49 * 9), peak=BF16_FLOPS_PER_S,
        library_ms=None)


def splat_work(order, offsets, N, C, ppp=8):
    """Bytes and operations of kernel 4 on one input, as this input needs
    them: per pixel its offset and outputs; the ids and alphas of the
    fragments it composites (the first ``ppp`` of each run; for zbuf the
    first id at least); the feature rows of their distinct points; the
    depths of the distinct points in front."""
    import torch
    dev = offsets.device
    npix = offsets.numel() - 1
    used = (offsets[1:] - offsets[:-1]).clamp(max=max(ppp, 1))
    pid = torch.repeat_interleave(torch.arange(npix, device=dev), used)
    start = torch.cumsum(used, 0) - used
    rank = torch.arange(pid.numel(), device=dev) - start[pid]
    n = order[offsets[:-1][pid] + rank] % N
    comp = rank < ppp
    ncomp = int(comp.sum())
    rows = torch.unique(n[comp]).numel()
    front = torch.unique(n[rank == 0]).numel()
    nbytes = (8 * pid.numel() + 4 * ncomp + 8 * (npix + 1) + 4 * front
              + 4 * C * rows + 4 * npix * (C + 2))
    return nbytes, float(ncomp) * (2 * C + 6)


def splat_forms(label, args, ppp=8):
    """Kernel 4 on one input: its error against the plain version, every
    form of it equal in bits to the chosen one and to a second launch, the
    run lengths, each form's time, and the bound.  ``args`` are
    composite's (order, offsets, alpha, z, feat)."""
    import torch
    from codd_torch.ops import splat
    got = splat.composite(*args, ppp)
    ref = splat.composite_plain(*args, ppp)
    torch.cuda.synchronize()
    # same fragment order; the plain version sums log-transmittance in f64
    err = _compare(f"splat_composite ({label})", got, ref, 1e-5, 1e-4)
    offsets, feat = args[1], args[4]
    N, C = feat.shape
    forms = [f for f in splat.FORMS if f != "auto"
             and (f != "walk" or C <= splat.WALK_C)]
    for f in ["auto"] + forms:
        again = splat.composite_form(*args, f, ppp)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"splat_composite ({label}): form {f} differs in bits")
    npix = offsets.numel() - 1
    run = offsets[1:] - offsets[:-1]
    nbytes, flops = splat_work(args[0], offsets, N, C, ppp)
    lb, _ = bound_ms(nbytes, flops)
    ms = cuda_ms(lambda: splat.composite(*args, ppp))
    times = {f: cuda_ms(lambda: splat.composite_form(*args, f, ppp))
             for f in forms}
    print(f"  splat ({label}): {npix} pixels, {N} points, C={C}, "
          f"{int(offsets[-1])} fragments, runs up to {int(run.max())} (mean "
          f"{float(run.float().mean()):.2f}, {float((run > ppp).float().mean()):.3f}"
          f" past {ppp}, {float((run == 0).float().mean()):.3f} empty); "
          f"composite {ms:.4f} ms (bound {lb:.4f} ms, {lb / ms:.2f} of it); "
          "forms, equal in bits: "
          + "  ".join(f"{f} {t:.4f}" for f, t in times.items()))
    return dict(err=err, ms=ms, bound_ms=lb, bytes=nbytes, flops=flops)


def splat_check(label, X, intr, h, w, radius, feat):
    """Kernel 4 at one call site on seeded points (``splat_forms``), the
    plain version's time and sort_fragments's (projection, torch.sort,
    searchsorted)."""
    import torch
    from codd_torch.ops import splat
    order, offsets, alpha, Z = splat.sort_fragments(X, intr, h, w, radius)
    args = (order, offsets, alpha, Z.contiguous(), feat)
    res = splat_forms(label, args)
    sort_ms = cuda_ms(lambda: splat.sort_fragments(X, intr, h, w, radius))
    print(f"  splat ({label}): sort_fragments {sort_ms:.4f} ms")
    return dict(res, plain_ms=cuda_ms(lambda: splat.composite_plain(*args)))


def kernel_checks(dev):
    import torch
    from codd_torch.ops import corr, gn, se3, splat, tile_warp
    from codd_torch.ops.projective import inv_project, project

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(dev)

    def rand(*s, lo=0.0, hi=1.0):
        return (torch.rand(s, generator=g) * (hi - lo) + lo).to(dev)

    rows = []

    # -- kernel 1: tile warp cost at the full-res call (384x1280, C=16) --
    C = 16
    fl, fr = randn(1, H, W, C), randn(1, H, W, C)
    hyp3 = torch.stack([rand(1, H // 4, W // 4, hi=320.0),
                        rand(1, H // 4, W // 4, lo=-1.0, hi=1.0),
                        rand(1, H // 4, W // 4, lo=-1.0, hi=1.0)], -1)
    got = tile_warp.tile_warp_cost(hyp3, fl, fr)
    ref = tile_warp.tile_warp_cost_plain(hyp3, fl, fr)
    torch.cuda.synchronize()
    # same floor() decisions by construction; sums of 16 |.| in another
    # order: f32 rounding only
    err = _compare("tile_warp_cost", got, ref, 1e-4, 1e-5)
    npx = H * W
    nbytes = 4 * (2 * npx * C + hyp3.numel() + got.numel())
    flops = npx * (18 * C + 10)
    row = dict(
        name="tile_warp_cost", source="codd_torch/csrc/tile_warp.cu",
        replaces="codd_tpu/ops/pallas/tile_warp.py:123", max_abs_err=err,
        ms=cuda_ms(lambda: tile_warp.tile_warp_cost(hyp3, fl, fr)),
        plain_ms=cuda_ms(lambda: tile_warp.tile_warp_cost_plain(hyp3, fl, fr)),
        bytes=nbytes, flops=flops, library_ms=None)
    # the bf16 forms on the same inputs rounded to bf16, each against its
    # plain version in bf16: within 1 bf16 ulp (a pixel's 16 channels are
    # summed in f32 in another order before the one rounding), almost all
    # equal; half the bytes of the f32 form
    b16 = [t.to(torch.bfloat16) for t in (hyp3, fl, fr)]
    row["bound_ms_bf16"], _ = bound_ms(nbytes / 2, flops)
    for form in ("exact", "pallas"):
        got = tile_warp.tile_warp_cost(*b16, form)
        ref = tile_warp.tile_warp_cost_plain(*b16, form)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
            fail(f"tile_warp_cost {form}: dtype {got.dtype} / {ref.dtype}")
        diff = (got.float() - ref.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.float().abs().clamp(min=1e-30))) - 7)
        ulps, unequal = float((diff / ulp).max()), float(
            (diff > 0).float().mean())
        row[f"max_abs_err_bf16_{form}"] = float(diff.max())
        row[f"ms_bf16_{form}"] = cuda_ms(
            lambda: tile_warp.tile_warp_cost(*b16, form))
        row[f"plain_ms_bf16_{form}"] = cuda_ms(
            lambda: tile_warp.tile_warp_cost_plain(*b16, form))
        print(f"  tile_warp_cost bf16 {form}: max_abs_err "
              f"{float(diff.max()):.3e} ({ulps:.2f} bf16 ulps, bound 1; "
              f"unequal share {unequal:.2e}, bound 1e-2); "
              f"{row[f'ms_bf16_{form}']:.4f} ms (f32 form {row['ms']:.4f}), "
              f"plain {row[f'plain_ms_bf16_{form}']:.4f} ms, bound "
              f"{row['bound_ms_bf16']:.4f} ms")
        if ulps > 1.0 or unequal > 1e-2:
            fail(f"tile_warp_cost bf16 {form}: kernel and plain version "
                 "disagree")
    rows.append(row)

    # -- kernels 2 and 6: the corr lookups, four levels in one launch, on
    # two coordinate fields of the 48x160 queries --
    h8, w8 = H // 8, W // 8
    n = h8 * w8
    f1, f2 = randn(1, h8, w8, 128), randn(1, h8, w8, 128)
    fields = corr_fields(randn(1, h8, w8, 2, scale=6.0), h8, w8, dev)
    vols = corr.build_corr_pyramid(f1, f2, 4, 3)
    rows.append(corr_volume_check(vols, fields))

    # -- kernels 3 and 5: GN aggregate (+ solve) at 48x160, C=32 --
    intr8 = torch.tensor([[721.5 / 8, 721.5 / 8, 609.6 / 8, 172.9 / 8]],
                         device=dev)
    depth = rand(1, h8, w8, lo=2.0, hi=60.0)
    Ts = se3.exp(randn(1, h8, w8, 6, scale=0.01))
    target = (project(se3.act(Ts, inv_project(depth, intr8)), intr8)
              + randn(1, h8, w8, 3, scale=0.5))
    weight = rand(1, h8, w8, 3)
    vals = gn.build_vals(Ts, target, weight, depth, intr8).contiguous()
    ae = randn(1, h8, w8, 32, scale=1.0 / 8).contiguous()
    ky = np.minimum(np.arange(h8) + 32, h8 - 1) - np.maximum(
        np.arange(h8) - 32, 0) + 1
    kx = np.minimum(np.arange(w8) + 32, w8 - 1) - np.maximum(
        np.arange(w8) - 32, 0) + 1
    pairs = float(ky.sum() * kx.sum())
    # kernel 3: ~4000-term f32 sums in another order, then a damped 6x6
    # solve.  With bf16 scores a sigmoid within an ulp of a bf16 rounding
    # boundary may round the other way than the plain version's (ex2.approx
    # and a refined rcp.approx against torch.sigmoid): 2^-9 relative on
    # that term, well inside rtol.
    # kernel 5: the same sums, written out.  The 27 columns differ by
    # orders of magnitude and the b columns cancel, so each element is held
    # to its own sum of |terms| (the scores are positive: the plain version
    # on |vals|): 1e-5 of it for ~4000 f32 terms in another order; with
    # bf16 scores 2^-12, for the few scores that land on a bf16 rounding
    # boundary and move their term by 2^-8.  No rtol.
    def gn_check(ae, tag, logit_noise=0.0):
        errs3, errs5 = [], []
        absum = gn.gn_window_aggregate_plain(ae, vals.abs())
        for bf in (False, True):
            label = tag + (" (bf16 scores)" if bf else "")
            got = gn.gn_fused_solve(ae, vals, bf16_scores=bf)
            ref = gn.gn_fused_solve_plain(ae, vals, bf16_scores=bf)
            torch.cuda.synchronize()
            errs3.append(_compare("gn_fused_solve" + label, got, ref,
                                  1e-5, 1e-3))
            got = gn.gn_window_aggregate(ae, vals, bf16_scores=bf)
            ref = gn.gn_window_aggregate_plain(ae, vals, bf16_scores=bf)
            torch.cuda.synchronize()
            share = (2.0 ** -12 if bf else 1e-5) + logit_noise
            errs5.append(_compare("gn_window_aggregate" + label, got, ref,
                                  share * absum + 1e-6, 0.0))
            err = (got - ref).abs()
            col_rel = (err.amax((0, 1, 2))
                       / ref.abs().amax((0, 1, 2)).clamp(min=1e-30))
            print(f"  gn_window_aggregate{label}: worst |err| / sum|terms| "
                  f"{float((err / (absum + 1e-6)).max()):.3e} (allowed "
                  f"{share:.3e}); worst |err| / max|column| "
                  f"{float(col_rel.max()):.3e} (column "
                  f"{int(col_rel.argmax())} of 27)")
            again = gn.gn_window_aggregate(ae, vals, bf16_scores=bf)
            if not torch.equal(got, again):
                fail(f"gn_window_aggregate{label}: two launches on one "
                     "input differ (the sums have a fixed order)")
        return max(errs3), max(errs5)

    err3, err5 = gn_check(ae, "")
    # the same at embedding scale 1.0: |q|^2 ~ 32 against logits near 0,
    # where the norms' cancellation bites and only a query's own term and
    # near neighbours survive.  Any f32 evaluation of 2 q.k - |q|^2 - |k|^2
    # rounds three terms of that size, and a logit off by d moves its term
    # by at most d of itself: 8 ulp of 2 max|q|^2 beside the flat share
    # (the plain version stands that far from an f64 evaluation itself,
    # tests/test_torch_gn.py).
    ae1 = randn(1, h8, w8, 32).contiguous()
    noise1 = 8 * 2.0 ** -24 * 2 * float((ae1 * ae1).sum(-1).max())
    e3, e5 = gn_check(ae1, ", scale 1.0", noise1)
    err3, err5 = max(err3, e3), max(err5, e5)
    evaluated = gn.tiling_pairs(h8, w8, 32)
    for name, src, rep, err, fn, plain, out_w, per_query in (
            ("gn_fused_solve", "gn_fused.cu", "gn_fused.py:214", err3,
             gn.gn_fused_solve, gn.gn_fused_solve_plain, 6, 264),
            ("gn_window_aggregate", "gn_window.cu", "gn_window.py:153", err5,
             gn.gn_window_aggregate, gn.gn_window_aggregate_plain, 27, 64)):
        rows.append(dict(
            name=name, source="codd_torch/csrc/" + src,
            replaces="codd_tpu/ops/pallas/" + rep, max_abs_err=err,
            ms=cuda_ms(lambda: fn(ae, vals)),
            plain_ms=cuda_ms(lambda: plain(ae, vals)),
            bytes=4 * n * (32 + 27 + out_w),
            # per pair: 32-wide dot (64), logit (3), sigmoid (3), 27 FMAs
            # (54); per query: norm (64) and, fused, the damped solve (~200)
            flops=pairs * 124 + n * per_query, library_ms=None))
        lb, _ = bound_ms(rows[-1]["bytes"], rows[-1]["flops"])
        bf_ms = cuda_ms(lambda: fn(ae, vals, bf16_scores=True))
        print(f"  {name}: {rows[-1]['ms']:.4f} ms = {rows[-1]['ms'] / lb:.2f} "
              f"x bound; bf16 scores {bf_ms:.4f} ms = {bf_ms / lb:.2f} x "
              f"bound; the tiling evaluates {evaluated:.0f} pairs for "
              f"{pairs:.0f} useful ({evaluated / pairs:.3f})")

    pyr = corr.build_corr_pyramid(f1, f2, 4, 3, impl="patch")
    rows.append(corr_patch_check(pyr, fields))

    # -- kernel 4: splat compositor at both call sites of the motion module:
    # full res (C=6, r=1; the row's time and bound) and quarter res (C=32,
    # r=2), built as codd_torch/models/motion/motion.py builds them --
    intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
    depth = rand(1, H, W, lo=2.0, hi=60.0)
    Ts = se3.exp(randn(1, H, W, 6, scale=0.01))
    X2 = se3.act(Ts, inv_project(depth, intr)).reshape(-1, 3)
    full = splat_check("full res 384x1280, C=6, r=1", X2, intr[0], H, W, 1.0,
                       randn(H * W, 6))
    # the forms at the walk's widest C, where the launcher still walks
    order, offsets, alpha, Z = splat.sort_fragments(X2, intr[0], H, W, 1.0)
    splat_forms(f"full res, C={splat.WALK_C}, the walk's widest",
                (order, offsets, alpha, Z.contiguous(),
                 randn(H * W, splat.WALK_C)))
    intr4 = intr / 4
    X2q = se3.act(Ts[:, 1::4, 1::4], inv_project(depth[:, 1::4, 1::4], intr4))
    quarter = splat_check("quarter res 96x320, C=32, r=2", X2q.reshape(-1, 3),
                          intr4[0], H // 4, W // 4, 2.0,
                          randn((H // 4) * (W // 4), 32))
    rows.append(dict(
        name="splat_composite", source="codd_torch/csrc/splat_composite.cu",
        replaces="codd_tpu/ops/pallas/splat_composite.py:165",
        max_abs_err=max(full["err"], quarter["err"]), ms=full["ms"],
        plain_ms=full["plain_ms"], bytes=full["bytes"], flops=full["flops"],
        library_ms=None, ms_quarter=quarter["ms"],
        bound_ms_quarter=quarter["bound_ms"]))

    for r in rows:
        r["bound_ms"], r["bound_by"] = bound_ms(
            r.pop("bytes"), r.pop("flops"), r.pop("peak", F32_FLOPS_PER_S))
        print(f"  {r['name']}: {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
              f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the streaming cascade
# ---------------------------------------------------------------------------

def frames(n: int, dev, seed: int = 1):
    """Seeded stereo frames of a smooth textured plane: the right view is
    the left one shifted by 8 + t whole pixels (disparity 8 + t), and the
    camera pans 2 pixels a frame."""
    import torch
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((1, 3, H // 8, (W + 64) // 8), generator=g)
    tex = torch.nn.functional.interpolate(base, size=(H, W + 64),
                                          mode="bilinear", align_corners=False)
    tex = tex + 0.1 * torch.rand(tex.shape, generator=g)
    out = []
    for t in range(n):
        left = tex[..., 2 * t:2 * t + W]
        shift = 8 + t  # whole-pixel shift keeps the right view exact
        right = tex[..., 2 * t + shift:2 * t + shift + W]
        out.append((left.permute(0, 2, 3, 1).contiguous().to(dev),
                    right.permute(0, 2, 3, 1).contiguous().to(dev)))
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the six hot ops to their plain PyTorch versions (phase 6)."""
    import torch
    from codd_torch.models.stereo import hitnet
    from codd_torch.ops import corr, gn, splat, tile_warp

    def corr_plain(vols, coords, radius=3, scales=None, out=None, offset=0):
        res = torch.cat([corr.corr_lookup_level_plain(v, coords * sc, radius)
                         for v, sc in zip(vols, corr._scales(len(vols), scales))],
                        -1)
        return corr._into(out, offset, res)

    def patch_plain(f1, levels, coords, radius=3, scales=None, out=None,
                    offset=0):
        res = torch.cat([corr.corr_patch_lookup_level_plain(
            f1, l, coords * sc, radius)
            for l, sc in zip(levels, corr._scales(len(levels), scales))], -1)
        return corr._into(out, offset, res)

    saved = (hitnet.tile_warp_cost, corr.corr_lookup_levels,
             gn.gn_fused_solve, splat.composite, gn.gn_window_aggregate,
             corr.corr_patch_lookup_levels)
    hitnet.tile_warp_cost = tile_warp.tile_warp_cost_plain
    corr.corr_lookup_levels = corr_plain
    gn.gn_fused_solve = gn.gn_fused_solve_plain
    splat.composite = splat.composite_plain
    gn.gn_window_aggregate = gn.gn_window_aggregate_plain
    corr.corr_patch_lookup_levels = patch_plain
    try:
        yield
    finally:
        (hitnet.tile_warp_cost, corr.corr_lookup_levels, gn.gn_fused_solve,
         splat.composite, gn.gn_window_aggregate,
         corr.corr_patch_lookup_levels) = saved


def bf16_copy(model):
    """A bf16 copy of ``model`` (parameters and buffers cast), as
    ``tools/bench.py --bf16`` runs it."""
    import copy
    from codd_torch.utils.precision import cast_floats
    return cast_floats(copy.deepcopy(model))


def build_model(name: str = "codd.py", **overrides):
    """A model of configs/models/<name> on the card, seeded weights;
    ``overrides`` replace top-level keys of its ``model`` dict."""
    from codd_torch.config import load_config
    from codd_torch.models.builder import build_estimator

    cfg = load_config(str(Path(__file__).resolve().parent / "configs"
                          / "models" / name))
    return build_estimator(dict(cfg["model"], **overrides), device="cuda",
                           seed=0)


def stream(model, intr, seq):
    """first_step + one step per further frame, each timed on the host
    clock up to a synchronize: (first_step s, [step ms], outputs)."""
    import torch
    t0 = time.perf_counter()
    carry, out = model.first_step(*seq[0], intr)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    step_ms, outs = [], [out]
    for left, right in seq[1:]:
        t0 = time.perf_counter()
        carry, out = model.step(carry, left, right, intr)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return t_first, step_ms, outs


@contextlib.contextmanager
def last_splat_inputs():
    """Keep the inputs of the last two splat composites run inside (one
    step's two call sites), features copied."""
    from codd_torch.ops import splat
    kept, real = [], splat.composite

    def keep(order, offsets, alpha, z, feat, points_per_pixel=8):
        kept.append(((order, offsets, alpha, z, feat.clone()),
                     points_per_pixel))
        del kept[:-2]
        return real(order, offsets, alpha, z, feat, points_per_pixel)

    splat.composite = keep
    try:
        yield kept
    finally:
        splat.composite = real


def main_path(dev, steps: int):
    import torch
    from codd_torch.ops import kernels

    model = build_model()
    intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
    seq = frames(steps + 1, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_counts()
    with last_splat_inputs() as splat_inputs:
        t_first, step_ms, outs = stream(model, intr, seq)
    launches = kernels.counts()

    expect = {"tile_warp_cost": 9 * (steps + 1), "corr_lookup": 16 * steps,
              "gn_fused_solve": 16 * steps, "splat_composite": 2 * steps,
              "gn_window_aggregate": 0, "corr_patch_lookup": 0}
    print(f"  launches {launches} (expected {expect})")
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    for t, o in enumerate(outs):
        d = o["pred_disp"]
        if d.shape != (1, H, W, 1) or not torch.isfinite(d).all():
            fail(f"frame {t}: pred_disp shape {tuple(d.shape)} or non-finite")
        for k in ("Ts", "flow2d_est_induced", "weight", "fusion_weights",
                  "reset_weights", "pred_warp"):
            if t and not torch.isfinite(o[k]).all():
                fail(f"frame {t}: non-finite {k}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  first_step {t_first * 1e3:.1f} ms; step ms {['%.1f' % s for s in step_ms]}"
          f"; median {float(np.median(step_ms)):.1f} ms/frame; peak {peak:.2f} GiB")
    print(f"  pred_disp frame {steps}: mean {float(outs[-1]['pred_disp'].mean()):.3f}"
          f" min {float(outs[-1]['pred_disp'].min()):.3f}"
          f" max {float(outs[-1]['pred_disp'].max()):.3f}")
    # kernel 4 on the last step's own inputs (launches after the count)
    for (args, ppp), label in zip(splat_inputs, ("main path, full res",
                                                 "main path, quarter res")):
        splat_forms(label, args, ppp)
    return model, intr, seq, launches, float(np.median(step_ms))


# ---------------------------------------------------------------------------
# phase 5: the dataset evaluation path
# ---------------------------------------------------------------------------

EVAL_RUNTIME = {"gn_impl": "pallas_window", "corr_impl": "patch"}
EVAL_FRAMES = 4


class PlaneSequences:
    """In-memory dataset in StereoVideoDataset's sample format: ``n``
    sequences of ``EVAL_FRAMES`` frames of the panning textured plane of
    ``frames()``, normalised like the test pipeline, with exact ground
    truth.  Pixel x of frame t shows texture column x + 2t at disparity
    8 + t, so towards frame t + 1 the flow is (-2, 0), the disparity grows
    by 1, and only the two leftmost columns leave the view (occluded)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def sequence_name(self, i):
        return f"plane/{i:02d}/0000.png"

    def __getitem__(self, i):
        import torch
        T = EVAL_FRAMES
        seq = frames(T, "cpu", seed=1 + i)
        mean = torch.tensor([123.675, 116.28, 103.53]) / 255.0
        std = torch.tensor([58.395, 57.12, 57.375]) / 255.0
        norm = lambda side: np.stack(  # frames() is in [0, 1.1]
            [((f[side][0] - mean) / std).numpy() for f in seq])
        disp = np.stack([np.full((H, W, 1), 8.0 + t, np.float32)
                         for t in range(T)])
        flow = np.zeros((T, H, W, 2), np.float32)
        flow[..., 0] = -2.0
        occ = np.zeros((T, H, W, 1), np.float32)
        occ[:, :, :2] = 1.0
        return {"imgs": norm(0), "r_imgs": norm(1), "gt_disp": disp,
                "gt_flow": flow,
                "gt_disp_change": np.ones((T, H, W, 1), np.float32),
                "gt_flow_occ": occ,
                "meta": {"filename": self.sequence_name(i),
                         "img_shape": (H, W), "ori_shape": (H, W),
                         "disp_range": (1.0, 210.0), "calib": None,
                         "intrinsics": [721.5, 721.5, 609.6, 172.9]}}


def _eval_run(label, model, n_seq, expect_per_seq, scene_flow=True):
    """run_inference over ``n_seq`` plane sequences; checks the launch
    counts and that every metric is finite, with count > 0 where the model
    yields a transform field (``scene_flow``)."""
    import torch
    from codd_torch.apis.evaluation import METER_NAMES, SUM_NAMES
    from codd_torch.apis.inference import run_inference
    from codd_torch.ops import kernels

    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    metrics = run_inference(model, PlaneSequences(n_seq), evaluate=True,
                            log=lines.append)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_seq
    launches = kernels.counts()
    expect = {k: v * n_seq for k, v in expect_per_seq.items()}
    print(f"  {label}: {ms:.1f} ms/sequence of {EVAL_FRAMES} frames over "
          f"{n_seq} (data made on the host included); peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"  {label}: launches {launches}")
    if launches != expect:
        fail(f"{label}: launch counts {launches} != expected {expect}")
    for k in METER_NAMES + SUM_NAMES:
        if k not in metrics or not np.isfinite(metrics[k]):
            fail(f"{label}: metric {k} missing or non-finite: {metrics}")
    if (metrics["count"] > 0) != scene_flow:
        fail(f"{label}: scene-flow count {metrics['count']}, expected "
             f"{'> 0' if scene_flow else '0'}")
    print("  " + "\n  ".join(l for line in lines for l in
                             str(line).strip().splitlines()))
    return launches, ms


def streams_in_turns(dev, default_model, model):
    """Profile phase: both configurations streamed in turns, for the
    spread of the host-bound ms/frame inside and between them."""
    import torch
    intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
    seq = frames(7, dev)
    meds = {"default": [], "second": []}
    for which in ("default", "second", "second", "default") * 2:
        m = default_model if which == "default" else model
        _, step_ms, _ = stream(m, intr, seq)
        meds[which].append(round(float(np.median(step_ms)), 1))
    print(f"  streaming, first_step + 6 steps, median ms/frame of each "
          f"stream, in turns (default, second, second, default) x 2: "
          f"default {meds['default']} (median "
          f"{float(np.median(meds['default'])):.1f}), pallas_window + "
          f"patch {meds['second']} (median "
          f"{float(np.median(meds['second'])):.1f})")


def eval_phase(dev, steps, default_ms):
    """Phase 5; returns the second configuration's model and its launch
    counts over the two sequences.  ``default_ms`` is the main path's
    median ms/frame over ``steps`` steps, or None."""
    import torch
    esteps = EVAL_FRAMES - 1
    tile = 9 * EVAL_FRAMES
    zero = {"corr_lookup": 0, "gn_fused_solve": 0, "gn_window_aggregate": 0,
            "corr_patch_lookup": 0, "splat_composite": 0}
    model = build_model(runtime=EVAL_RUNTIME)
    launches, _ = _eval_run(
        "pallas_window + patch", model, 2,
        dict(zero, tile_warp_cost=tile, gn_window_aggregate=16 * esteps,
             corr_patch_lookup=16 * esteps, splat_composite=2 * esteps))
    # the main path's stream once more in this configuration; the step is
    # host-bound, so one stream each orders the two loosely (the profile
    # phase repeats them in turns and splits the device time)
    if default_ms is not None:
        intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
        _, step_ms, _ = stream(model, intr, frames(steps + 1, dev))
        print(f"  streaming, first_step + {steps} steps, median ms/frame: "
              f"default {default_ms:.1f} (phase 4), pallas_window + patch "
              f"{float(np.median(step_ms)):.1f}")
    _eval_run("GTMotion + GTFusion",
              build_model(motion={"type": "GTMotion"},
                          fusion={"type": "GTFusion"}), 1,
              dict(zero, tile_warp_cost=tile))
    _eval_run("Motion + KalmanFusion",
              build_model(fusion={"type": "KalmanFusion"}), 1,
              dict(zero, tile_warp_cost=tile, corr_lookup=16 * esteps,
                   gn_fused_solve=16 * esteps, splat_composite=2 * esteps))
    _eval_run("stereo only (configs/models/stereo.py)",
              build_model("stereo.py"), 1, dict(zero, tile_warp_cost=tile),
              scene_flow=False)
    return model, launches


def plain_check(model, intr, seq, label: str, gate: bool = True):
    """One frame pair through the kernels and through the plain versions.
    Each stage's share of moved pixels (> 1e-2 * (1 + |plain|)) is printed:
    frame 0's stereo disparity, frame 1's stereo disparity, its induced
    flow, the motion-warped disparity, the fusion weights and the fused
    disparity; the first stage that moved names where the runs part.
    ``gate`` fails the run where more than 1e-3 of a disparity moved (the
    bf16 model is reported only: at random weights bf16 is chaotic)."""
    import torch
    print(f"  {label}:")
    carry, out0_k = model.first_step(*seq[0], intr)
    _, out_k = model.step(carry, *seq[1], intr)
    with plain_versions():
        carry, out0_p = model.first_step(*seq[0], intr)
        _, out_p = model.step(carry, *seq[1], intr)
    torch.cuda.synchronize()
    stages = [("stereo, frame 0", out0_k["pred_disp"], out0_p["pred_disp"]),
              ("stereo, frame 1", out_k["pred_curr"], out_p["pred_curr"]),
              ("induced flow", out_k["flow2d_est_induced"],
               out_p["flow2d_est_induced"]),
              ("motion-warped", out_k["pred_warp"], out_p["pred_warp"]),
              ("fusion weights", out_k["fusion_weights"],
               out_p["fusion_weights"]),
              ("fused", out_k["pred_disp"], out_p["pred_disp"])]
    shares = []
    for name, a, b in stages:
        a, b = a.float(), b.float()
        err = (a - b).abs()
        # random weights: argmax/floor decisions on near-ties may flip on
        # f32 sum-order differences, so a small share of pixels may move
        share = float((err > 1e-2 * (1 + b.abs())).float().mean())
        shares.append(share)
        print(f"  {name}: max_abs_err {float(err.max()):.3e}  median "
              f"{float(err.median()):.3e}  share > 1e-2*(1+|plain|) "
              f"{share:.2e}")
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite kernel output")
    first = next((st[0] for st, sh in zip(stages, shares) if sh > 0), None)
    print(f"  the runs part at: {first or 'no stage'}")
    if not gate:
        return
    for key in ("pred_curr", "pred_warp", "pred_disp"):
        a, b = out_k[key], out_p[key]
        share = float(((a - b).abs() > 1e-2 * (1 + b.abs())).float().mean())
        if share > 1e-3:
            fail(f"{key}: kernel run disagrees with the plain run")


def bench_phase():
    """``codd_torch/tools/bench.py`` in this process, a few calls each: f32
    and bf16 at 384x1280, and bf16 --batch 2; each run's lines and its
    JSON line.  The bf16 run's launches a call must be the f32 path's
    (kernel 1 in its bf16 form).  Returns the bf16 run's launches."""
    from codd_torch.tools import bench

    base = ["--height", str(H), "--width", str(W), "--iters", "5",
            "--warmup", "2"]
    res = {}
    for label, extra, B in (("f32", [], 1), ("bf16", ["--bf16"], 1),
                            ("bf16 batch 2", ["--bf16", "--batch", "2"], 2)):
        # the splats run image by image: two a batch element
        per_call = {"tile_warp_cost": 9, "corr_lookup": 16,
                    "gn_fused_solve": 16, "splat_composite": 2 * B}
        print(f"  tools/bench.py {' '.join(base + extra)}", flush=True)
        r = bench.run(bench.parse_args(base + extra),
                      log=lambda line: print(f"    {line}"))
        print("    " + json.dumps(r["line"]), flush=True)
        if r["launches_per_call"] != per_call:
            fail(f"bench {label}: launches a call {r['launches_per_call']} "
                 f"!= {per_call}")
        if not r["line"]["value"] > 0:
            fail(f"bench {label}: no throughput: {r['line']}")
        res[label] = r
    return {k: int(v * 5) for k, v in res["bf16"]["launches_per_call"].items()}


def profile_step(model, intr, seq, out_file: Path):
    """torch.profiler over one step: device time by kernel, the hand
    kernels' share, and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    carry, _ = model.first_step(*seq[0], intr)
    model.step(carry, *seq[1], intr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.step(carry, *seq[1], intr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only: CPU ops would count their kernels twice
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    hand = {"tile_warp_cost_kernel": "tile_warp_cost",
            "corr_lookup_kernel": "corr_lookup",
            "gn_fused_solve_kernel": "gn_fused_solve",
            "splat_composite_": "splat_composite",  # _walk or _lanes
            "gn_window_aggregate_kernel": "gn_window_aggregate",
            "corr_patch_lookup_kernel": "corr_patch_lookup"}
    mine = {v: sum(r[1] for r in rows if k in r[0]) for k, v in hand.items()}
    cats: dict = {}
    for key, ms, n in rows:
        c = cats.setdefault(_category(key, hand), [0.0, 0])
        c[0] += ms
        c[1] += n
    lines = [f"one step at {H}x{W}: wall {wall_ms:.3f} ms, device busy "
             f"{busy:.3f} ms in {sum(r[2] for r in rows)} launches; idle "
             f"share {max(0.0, 1 - busy / wall_ms):.3f} (profiled)"]
    lines += [f"  {name}: {ms:.3f} ms ({100 * ms / busy:.1f} %), {n} launches"
              for name, (ms, n) in sorted(cats.items(), key=lambda c: -c[1][0])]
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w") as f:
        f.write("\n".join(lines) + "\n")
        for key, ms, n in rows:
            f.write(f"{ms:10.4f} ms {n:6d}x  {key}\n")
    print("  " + "\n  ".join(lines))
    print(f"  hand kernels ms/step {json.dumps({k: round(v, 4) for k, v in mine.items()})}")
    for key, ms, n in rows[:12]:
        print(f"  {ms:9.3f} ms {n:5d}x  {key[:90]}")


def _category(kernel: str, hand) -> str:
    """Coarse owner of a device kernel, by its name, for the time split."""
    if any(k in kernel for k in hand):
        return "hand-written kernels"
    if any(k in kernel.lower() for k in ("sort", "searchsorted")):
        return "sort / searchsorted (splat)"
    # cuDNN's implicit-GEMM, direct and FFT convolutions and its layout
    # transposes; the complex (float2) GEMM/GEMV and transforms are the
    # FFT convolutions' products
    if any(k in kernel for k in ("cudnn", "fprop", "dgrad", "convolve",
                                 "DSE::", "nhwcToNchw", "nchwToNhwc",
                                 "region_transform", "float2")):
        return "cuDNN convolutions"
    if "gemm" in kernel or "gemv" in kernel:
        return "cuBLAS GEMM / GEMV"
    return "ATen elementwise / reduce / copy / gather"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,main,eval,plain,bench",
                    help="comma list of kernels, main, eval, plain, bench, "
                         "profile (profile writes chiprun_out/profile_step*.txt"
                         ", the bf16 model's too, and streams both "
                         "configurations in turns)")
    ap.add_argument("--steps", type=int, default=3,
                    help="step calls of the main path after first_step")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    unknown = phases - {"kernels", "main", "eval", "plain", "bench",
                        "profile"}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")

    try:
        import torch
        from codd_torch.ops import kernels
        from codd_torch.utils.precision import cast_floats
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    print(f"[1/6] device: {name} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    kernels.load(verbose=True)
    print(f"[2/6] built {len(kernels.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    if "kernels" in phases:
        print("[3/6] kernels against their plain versions", flush=True)
        rows = kernel_checks(dev)
    launches, eval_launches = {}, {}
    model = eval_model = default_ms = None
    if "main" in phases:
        print(f"[4/6] streaming cascade 384x1280, first_step + {args.steps} "
              "steps", flush=True)
        model, intr, seq, launches, default_ms = main_path(dev, args.steps)
    if "eval" in phases:
        print(f"[5/6] run_inference(evaluate=True), runtime {EVAL_RUNTIME}, "
              f"2 sequences x {EVAL_FRAMES} frames at 384x1280; then the "
              "oracle and stereo-only variants", flush=True)
        eval_model, eval_launches = eval_phase(dev, args.steps, default_ms)
    if "plain" in phases:
        print("[6/6] one frame pair through the plain versions", flush=True)
        intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
        seq = frames(2, dev)
        if model is not None:
            plain_check(model, intr, seq, "default runtime")
        if eval_model is not None:
            plain_check(eval_model, intr, seq, f"runtime {EVAL_RUNTIME}")
        if model is not None:
            plain_check(bf16_copy(model), intr, cast_floats(seq),
                        "default runtime, bf16 (reported, not gated)",
                        gate=False)
    bf16_launches = {}
    if "bench" in phases:
        print("[bench] tools/bench.py at 384x1280: f32, bf16, bf16 batch 2",
              flush=True)
        bf16_launches = bench_phase()
    if "profile" in phases:
        if model is None and eval_model is None:
            fail("the profile phase needs the main or the eval phase")
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
        seq = frames(2, dev)
        for m, label, fname, fr in (
                (model, "default runtime", "profile_step.txt", seq),
                (eval_model, f"runtime {EVAL_RUNTIME}",
                 "profile_step_eval.txt", seq),
                (model and bf16_copy(model), "default runtime, bf16",
                 "profile_step_bf16.txt", cast_floats(seq))):
            if m is not None:
                print(f"[profile] one step under torch.profiler, {label}",
                      flush=True)
                profile_step(m, intr, fr, out_dir / fname)
        if model is not None and eval_model is not None:
            print("[profile] both configurations streamed in turns",
                  flush=True)
            streams_in_turns(dev, model, eval_model)
    # each path was driven with the counts at 0; a kernel's launches are
    # the default path's plus the evaluation path's
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = (launches.get(r["name"], 0)
                         + eval_launches.get(r["name"], 0))
        if r["launches"] == 0 and {"main", "eval"} <= phases:
            fail(f"{r['name']}: launched no time on the main paths")
        if r["name"] == "tile_warp_cost" and bf16_launches:
            r["launches_bf16"] = bf16_launches["tile_warp_cost"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_quarter", "bound_ms_quarter", "launches_bf16",
            "max_abs_err_bf16_exact", "ms_bf16_exact", "plain_ms_bf16_exact",
            "max_abs_err_bf16_pallas", "ms_bf16_pallas",
            "plain_ms_bf16_pallas", "bound_ms_bf16")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
