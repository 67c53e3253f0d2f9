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
     their plain bf16 versions, each timed beside the f32 form, with the
     share of outputs off their plain version's bits, and its backward
     (the VJP of tile_warping) against the plain backward on the random
     and on a smooth field (shared taps; the row's ``ms_smooth``), its
     three outputs equal in bits on two launches, timed at each channel
     group a pass of its row block takes (16, 8, 4), in bf16 also at the
     training call with taps past both edges, four launches each the
     first's bits (dhyp3 and dfea_l the plain version's); the
     backward of kernels 5 and 6 at the motion stage's training call (B=4,
     48x96 queries) against their plain backward, timed, with their
     bounds: kernel 5's (tensor-core products) twice for equal bits, and
     its bf16-score form (the VJP of codd_tpu's windowed sums with bf16
     scores) at the same call with a 384x1024 crop (48x128 queries) on a
     random and a smooth embedding field, each element within one bf16
     ulp of its sum of |terms| beyond the f32 bound, twice for equal bits,
     with the share beyond the f32 bound, its registers and spill and the
     f32 form's time on the same inputs;
     kernel 6's (products over each tile's window box, staged in chunks)
     on the smooth and the scattered field, df1 twice for equal bits, the
     share of blocks whose box is one chunk and the global atomics it
     adds into the levels' gradients (the row's ``one_chunk_share``,
     ``global_adds`` and ``ms_scattered``); the lookup's coordinate
     gradient at the same call (a block a tile and level, each tile's tap
     dots one tensor-core product over its window box, staged in chunks)
     against its plain version on both fields, twice for equal
     bits, with the share of boxes that are one chunk (the row's
     ``ms_scattered`` and ``one_chunk_share``); the volume lookup's
     backward 2b at the same call, for both selects ("xla", "reduce") on
     both fields, dense and adding into a running cotangent, against its
     plain backward (the volumes' cotangents in bits, the coordinates'
     within 1e-5 of their sum of |terms|), twice for equal bits, timed
     as the training step calls it, adding into the running cotangent
     (the row's time; ``ms_cold`` with the L2 cache cold), and as the
     dense VJP with the wrapper's ``torch.zeros`` (``ms_dense``,
     ``bound_ms_dense``), beside grid_sample's backward on row 2's views
     (``library_ms``); kernel 4's backward at the
     joint stage's two splat calls (one image of B=4: full res 384x768,
     C=6, r=1, the row's time; quarter res 96x192, C=32, r=2, the row's
     ``ms_quarter``) on random cotangents against its plain backward,
     twice for equal bits; beside the times of the two kernels redesigned
     last (5b bf16, 1b bf16), the parent revision's forms' as ``python -m
     codd_torch.tools.kernel_cutouts --source`` measured them
     (``MS_BEFORE``, printed only);
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
  train: a training step on the card, 5 steps a stage at B=4, T=2,
     384x768 (SceneFlow's training crop) on seeded synthetic batches:
     the stereo stage (configs/models/stereo.py, Adam 4e-4 MultiGamma,
     clip 1.0), one stereo step with ``tile_warp_variant="tilewin"``
     (codd_tpu's windowed warp as ATen ops: no hand kernel launches), the
     fusion stage (configs/models/codd.py with stereo
     and motion frozen, OneCycle 2e-4), then the motion stage
     (configs/models/stereo_motion.py: stereo frozen, no fusion, RAFT-3D
     trained by motion_loss; OneCycle 2e-4, on the panning plane, whose
     flow and disparity change are known in closed form), one step of the
     motion stage with ``corr_impl="volume"`` (kernel 2 forward twice an
     iteration, 2b once, in place of 6 and 6b; the backward fills one
     running cotangent of the volumes and adds no volume-shaped tensor,
     the 16 calls of 2b add into it, each against its plain backward, and
     what reaches the volumes' matmul is the in-order bf16 sum of the 16
     plain dense cotangents in bits; the batch's gradients with 2b's
     plain backward within 1e-3), one step of the motion stage with
     ``gn_bf16_scores`` at 384x1024 crops (kernel 5's bf16-score backward
     16 times a step, on each of its calls against its plain backward, the
     batch's gradients with its plain backward within 1e-3), then the joint
     stage (configs/models/codd.py with the stereo frozen: RAFT-3D and
     the fusion trained together, the splats differentiated by kernel 4's
     backward; OneCycle 2e-4, the motion stage's batches), then the full
     joint stage (configs/models/codd.py as it stands, nothing frozen,
     schedule_stereo's Adam 4e-4 MultiGamma, clip 1.0, as
     configs/training_config.py composes them: kernel 1's backward and
     the correlation lookup's coordinate gradient too); each step's loss,
     grad_norm, ms (CUDA events) and the stage's peak memory and
     launches.  Fails on a non-finite loss, a stereo stage without kernel
     1's backward, a fusion stage that launches a backward or misses one
     of kernels 1-4, a motion stage whose launches a step are not kernels
     5 and 6 32 times forward (each GN iteration is recomputed in the
     backward) and 16 times backward, kernel 1 18 times, kernel 4 twice an
     image, its backward, kernels 2 and 3 never, a joint stage whose
     launches a step are not the motion stage's with kernel 4's backward
     twice an image, a full joint stage whose launches a step are not the
     joint stage's with kernel 1's backward 18 times and the coordinate
     gradient 16 times, a frozen parameter that moved,
     kernel 1's backward off its plain version on one stereo step's own
     calls, stereo gradients with the kernels beyond 1e-5 of those with
     kernel 1's plain backward alone or beyond 1e-3 of those with its
     plain forward and backward, the backward of kernels 5 or 6 off its
     plain version on one motion step's own 16 calls, motion gradients
     beyond 1e-3 of those with both backward kernels swapped for their
     plain versions (printed beside the run-to-run difference of the
     kernels' own gradients), kernel 4's backward off its plain version
     on one joint step's own 8 calls or the coordinate gradient on one
     full joint step's own 16, joint gradients beyond 1e-3 of those with
     these two swapped for their plain versions, a stereo gradient in the
     joint stage, or none in the full joint stage.  Then the stereo and
     the full joint stage again under bf16 compute
     (``make_train_step(bf16_compute=True)``: f32 masters, bf16 copies in
     the step), 5 steps each, after one batch's gradient checks; these
     fail also on kernel 1 or 1b taking anything but bf16 or another
     kernel other dtypes than in its f32 stage, 1b off its plain bf16
     version on the step's own 18 calls, a gradient beyond
     ``BF16_GRAD_BOUND`` of its norm (counted as at least
     ``BF16_NORM_FLOOR`` of the largest) from the one with 1b's plain
     bf16 backward alone (both with 6b's plain backward and deterministic
     cuDNN and ATen: 6b's atomics are their run-to-run order), launches a
     step other than the f32 stage's, or a master parameter or Adam
     moment that is not f32.
  entry: the training entry, ``python -m codd_torch.tools.train``'s path,
     in this process: a SceneFlow-shaped synthetic dataset (3 sequences x
     4 frames of 540x960, the train phase's panning plane with its ground
     truth in closed form: 8-bit PNGs whose rows cycle through the five
     filter types, PFM disparity, flow and disparity change, a split
     file), every PNG through the native decoder and through read_png
     (equal bytes, ms a frame of each); configs/training_config.py with
     only the data paths, checkpoint.interval=2, evaluation.interval=4
     and log_interval=1 overridden (codd.py, nothing frozen, 384x768
     crops, photometric asym, B=4, T=2, Adam 4e-4 MultiGamma, clip 1.0);
     (a) ``train_estimator(max_steps=4)``, with validation at step 4 on
     the val split padded to 576x960; (b) a fresh run resumed from ckpt_2
     to step 4; (c) the CLI for one step in a subprocess; (d) 2 steps
     with ``runtime.bf16_compute=True``, no validation; between them,
     the train phase's full joint step on in-memory batches of the same
     shape.  Per step: loss, grad_norm, host ms (data included) and the
     ms spent waiting on the prefetcher, as ``train_estimator`` writes
     them into metrics.jsonl, and launches; the peak memory, the
     validation's metric table, ms and launches.  Fails on a non-finite
     loss, a step whose launches are not the full joint stage's, a
     validation whose launches are not the default configuration's per
     frame (phase 4), a checkpoint that does not reload to the saved
     state in bits, a resumed run that does not start at step 2 with
     Adam's count 2 on run (a)'s batches, a frozen parameter (the config
     freezes none), a bf16 run (d) without codd_tpu's bf16 log line or
     whose ckpt_2 does not hold the f32 masters and moments in bits, a
     native decode off read_png's bytes, or a CLI run that exits
     non-zero.
  bench: ``codd_torch/tools/bench.py`` in this process at 384x1280, a few
     calls each, f32, ``--bf16`` and ``--bf16 --batch 2``: each run's
     lines (ms a call, stream ms, launches a call, peak memory, the card)
     and its JSON line; the launches a call must be the main path's.
  dist: multi-process training on the one card, after the build (the
     ranks load its libraries): (a) ``python -m torch.distributed.run
     --standalone --nproc_per_node=1`` of the training CLI over NCCL, 2
     steps of configs/training_config.py with ``corr_impl="volume"`` (no
     kernel of the step adds by atomics) on the entry phase's PNG data,
     against the same 2 steps without torchrun, both under deterministic
     cuDNN and ATen: ckpt_2 equal in bits; (b) two ranks on the one card
     over gloo (NCCL takes one rank a GPU), one stereo-stage step under
     SGD with 2 rows each of the train phase's first batch, against one
     process on the 4 rows under ``deterministic()``: each parameter's
     change within 1e-4 of its norm, loss and grad_norm to 1e-4; the
     phase's seconds.
  weights: a reference CODD checkpoint through utils/port_weights.py: the
     default model (configs/models/codd.py, max_disp 320, 16 GN
     iterations) with seeded weights on the card, its state_dict written
     under the reference's names (the port's tables read backward, with
     BatchNorm's num_batches_tracked and the HITLoss plane-fit convs) to
     a .pth under build/, converted by port_codd_checkpoint and saved,
     then loaded into a second model (another seed) by
     train/checkpoint.py:restore_params, ``--load-from``'s loader; both
     stream first_step + 2 steps at 384x1280 with launch counts; the last
     frame's point cloud from vis_point_cloud.disparity_to_points on the
     card, written by write_ply; the point count and the phase's seconds.
     Fails on a missing prefix, other plane-fit kernels, a tensor off the
     original's bits, launches other than the main path's a frame,
     pred_disp moved on more than 1e-3 of the pixels (phase 6's rule), or
     a point cloud other than the same function's on the CPU.
  loader (not in the default phases; with entry): the in-memory step
     with the entry's data work beside it, a batch drawn and dropped a
     step, in the entry's prefetch thread and in a process of its own
     (which must draw a batch a step and exit 0): the data's host work
     without its use.
  profile (not in the default phases): one step of each configuration,
     and of the default one in bf16, under torch.profiler, split by
     category into chiprun_out/profile_step*.txt; both configurations
     streamed in turns; with the train phase, one more training step of
     each stage into chiprun_out/profile_train_{stereo,fusion,motion,
     volume_motion,joint,joint_full}.txt, and one batch of the motion and the joint stage run
     twice in several configurations (each backward kernel alone,
     deterministic cuDNN and ATen), the gradients' run-to-run difference
     traced.

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

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 in the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, dense TF32 in the tensor cores
# an f32 product to f32 accuracy on the tensor cores: three TF32 products
# (3xTF32); where one operand is exact in bf16, three bf16 products (the
# other operand as three bf16 parts that add to it exactly)
F32_3XTF32_PER_S = TF32_FLOPS_PER_S / 3
F32_3XBF16_PER_S = BF16_FLOPS_PER_S / 3
H, W = 384, 1280
# the parent revision's times of the two backward kernels redesigned last
# (5b bf16 at B=4, 48x128 on the random field; 1b bf16 at the training
# call, 4 x 384x768 with taps past both edges, and at 384x1280 on the
# random and the smooth field), printed beside this run's: python -m
# codd_torch.tools.kernel_cutouts --kernel gn_backward and --kernel
# tile_warp, --source the parent's codd_torch/csrc, in turns with the new
# forms (parent, new, new, parent), the mean of the parent's four readings
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6)
MS_BEFORE = {"gn_window_aggregate_backward_bf16": {"random": 0.85005},
             "tile_warp_cost_backward_bf16": {"training call": 0.22885,
                                              "random": 0.157575,
                                              "smooth": 0.15075}}
# kernel 4's backward against its plain version: the plain version's
# index_add_ adds by float atomics, which flush subnormals to zero on the
# card, so a sum of up to K = 16 products may lose 16 x 2^-126
SPLAT_FLOOR = 2.0 ** -122


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, flops, peak: float = F32_FLOPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak.  ``flops`` is a count
    at ``peak``, or a list of (count, peak): each kind of operation at the
    rate of the unit that runs it."""
    if not isinstance(flops, list):
        flops = [(flops, peak)]
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = sum(f / p for f, p in flops)
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


def _grid_sample_views(vol, coords, i):
    """Level ``i``'s bf16 volume as grid_sample's (B*N, 1, Hp, Wp) input
    and the query's 7 x 7 window points on it (align_corners), a query a
    batch row: the volume lookup as one library call."""
    import torch
    B, N, Hp, Wp = vol.shape
    d = torch.arange(-3, 4, device=coords.device, dtype=torch.float32)
    c = coords.reshape(B * N, 1, 1, 2) / 2 ** i + 7.0  # padded grid
    pts = torch.stack(torch.broadcast_tensors(
        c[..., 0] + d[None, None, :], c[..., 1] + d[None, :, None]), -1)
    grid = (2 * pts / torch.tensor([Wp - 1.0, Hp - 1.0],
                                   device=coords.device) - 1
            ).to(torch.bfloat16)
    return vol.reshape(B * N, 1, Hp, Wp), grid


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
    N = vols[0].shape[1]
    lib = []
    for i, v in enumerate(vols):
        img, grid = _grid_sample_views(v, coords, i)
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


def splat_backward_check(label, X, intr, h, w, radius, feat, g, gz, ppp=8):
    """Kernel 4's backward at one training call on seeded points and random
    cotangents, against ``composite_backward_plain`` on the same saved
    forward: each element within 1e-5 of its sum of |terms|
    (``composite_backward_terms``: f32 sums against the plain version's f64
    transmittance and suffix sums, a transmittance T counted (1 + |log T|)
    times as the kernel sums log T in f32, dalpha's suffix part over
    1 - alpha) plus 2^-122 (``SPLAT_FLOOR``: the plain version's atomics
    flush subnormals);
    two launches equal in bits; its time, the plain version's, and the
    bytes and operations the function needs on this input: per run
    fragment its 8-byte id, per fragment its alpha (read) and dalpha
    (written), per pixel its offset and cotangents, the feature rows of
    the points composited, dfeat and dz; per composited fragment its dot
    and dfeat's products (4C) and ~12 scalar operations."""
    import torch
    from codd_torch.ops import splat
    order, offsets, alpha, Z = splat.sort_fragments(X, intr, h, w, radius)
    args = (order, offsets, alpha, feat, g, gz, ppp)
    got = splat.composite_backward(*args)
    ref = splat.composite_backward_plain(*args)
    terms = splat.composite_backward_terms(*args)
    again = splat.composite_backward(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"splat_composite_backward ({label}): two launches differ in "
             "bits (its sums have a fixed order)")
    err, worst = 0.0, 0.0
    for name, a, b, t in zip(("dfeat", "dalpha", "dz"), got, ref, terms):
        if not torch.isfinite(a).all():
            fail(f"splat_composite_backward ({label}): non-finite {name}")
        e = (a - b).abs()
        share = float((e / (1e-5 * t + SPLAT_FLOOR)).max())
        if share > 1.0:
            fail(f"splat_composite_backward ({label}): {name} disagrees with "
                 f"its plain backward ({share:.3f} of its allowance)")
        err = max(err, float(e.max()))
        worst = max(worst, share)
    N, C = feat.shape
    npix, M = h * w, order.numel()
    used = (offsets[1:] - offsets[:-1]).clamp(max=ppp)
    Mr, ncomp = int(offsets[-1]), int(used.sum())
    pid = torch.repeat_interleave(torch.arange(npix, device=X.device), used)
    rank = torch.arange(ncomp, device=X.device) - (torch.cumsum(used, 0)
                                                     - used)[pid]
    rows = torch.unique(order[offsets[:-1][pid] + rank] % N).numel()
    nbytes = (8 * Mr + 8 * M + 8 * (npix + 1) + 4 * npix * (C + 1)
              + 4 * C * rows + 4 * N * (C + 1))
    flops = float(ncomp) * (4 * C + 12)
    ms = cuda_ms(lambda: splat.composite_backward(*args))
    plain_ms = cuda_ms(lambda: splat.composite_backward_plain(*args))
    lb, by = bound_ms(nbytes, flops)
    print(f"  splat_composite_backward ({label}): {N} points, {M} fragments "
          f"({Mr} in runs, {ncomp} composited), C={C}: {ms:.4f} ms "
          f"(bound {lb:.4f} ms by {by}, {ms / lb:.1f}x), plain "
          f"{plain_ms:.4f} ms; "
          f"worst |err| {worst:.3f} of its allowance (1e-5 of the sum of "
          f"|terms| + 2^-122), max |err| "
          f"{err:.3e}; equal in bits on two launches", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
                bound_ms=lb)


def tile_warp_backward_check(hyp3, fl, fr, gout):
    """Kernel 1's backward at the full-res call against its plain version
    (the VJP of tile_warping, scatter by index_add_), on the random field
    and on a smooth one (one disparity, no slant: neighbouring pixels share
    their taps); all three outputs equal in bits on two launches; the time
    at channel groups of 16, 8 and 4 channels a pass."""
    import torch
    from codd_torch.ops import tile_warp
    smooth = torch.zeros_like(hyp3)
    smooth[..., 0] = 20.3
    err = 0.0
    for label, h in (("random", hyp3), ("smooth", smooth)):
        got = tile_warp.tile_warp_cost_backward(gout, h, fl, fr)
        ref = tile_warp.tile_warp_cost_backward_plain(gout, h, fl, fr)
        again = tile_warp.tile_warp_cost_backward(gout, h, fl, fr)
        torch.cuda.synchronize()
        # the same floor() and sign decisions; dhyp3 sums 16 pixels x 16
        # channels x 3 offsets in another order, dfea_r gathers up to 12
        # terms a value in the stable sort's order (index_add_'s atomics
        # vary the plain version's): 1e-5 of each output's largest value
        # and 1e-5 relative
        err = max(err, *(_compare(f"tile_warp_cost_backward {label} {n}", a,
                                  b, 1e-5 * float(b.abs().max()), 1e-5)
                         for n, a, b in zip(("dhyp3", "dfea_l", "dfea_r"),
                                            got, ref)))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"tile_warp_cost_backward {label}: two launches differ")
        if not torch.equal(got[1], ref[1]):
            fail(f"tile_warp_cost_backward {label}: dfea_l is not the plain "
                 "backward's bits")
    npx, C = fl.shape[1] * fl.shape[2], fl.shape[3]
    ms_smooth = cuda_ms(lambda: tile_warp.tile_warp_cost_backward(
        gout, smooth, fl, fr))
    by_group, budget = {}, tile_warp.BWD_ROW_BYTES
    try:
        for cg in (16, 8, 4):
            tile_warp.BWD_ROW_BYTES = fl.shape[2] * cg
            by_group[cg] = cuda_ms(lambda: tile_warp.tile_warp_cost_backward(
                gout, hyp3, fl, fr))
    finally:
        tile_warp.BWD_ROW_BYTES = budget
    print("  tile_warp_cost_backward: smooth field "
          f"{ms_smooth:.4f} ms; by channel group (random field) "
          + ", ".join(f"{k}: {v:.4f} ms" for k, v in by_group.items())
          + f" (the wrapper takes "
          f"{tile_warp.backward_channel_group(fl.shape[2], C)})")
    # read hyp3, fea_l, fea_r, g once; write dhyp3, dfea_l, dfea_r once
    nbytes = 4 * (2 * hyp3.numel() + 4 * npx * C + gout.numel())
    # per pixel, channel and offset: lerp, sign, dfea_l, two taps and
    # dlocal (~12); per pixel the plane (~10)
    flops = npx * (36 * C + 10)
    row = dict(
        name="tile_warp_cost_backward", source="codd_torch/csrc/tile_warp.cu",
        replaces="codd_tpu/models/stereo/hitnet.py:260", max_abs_err=err,
        ms=cuda_ms(lambda: tile_warp.tile_warp_cost_backward(
            gout, hyp3, fl, fr)),
        plain_ms=cuda_ms(lambda: tile_warp.tile_warp_cost_backward_plain(
            gout, hyp3, fl, fr)),
        ms_smooth=ms_smooth, bytes=nbytes, flops=flops, library_ms=None)
    row.update(tile_warp_backward_bf16(hyp3, smooth, fl, fr, gout, nbytes,
                                       flops))
    return row


def tile_warp_backward_bf16_compare(label, args, quiet=False):
    """The bf16 backward kernel against its plain version on ``args`` (g,
    hyp3, fea_l, fea_r in bf16): dhyp3 and dfea_l equal in bits (the same
    bf16 steps in the same order); dfea_r within one bf16 ulp of the plain
    value plus n 2^-24 of its sum of |terms| (both sum a column's n tap
    cotangents in f32, in other orders, and round once); all three equal
    in bits on two launches.  Returns (max |err|, the share of dfea_r off
    the plain version's bits)."""
    import torch
    from codd_torch.ops import tile_warp
    got = tile_warp.tile_warp_cost_backward(*args)
    again = tile_warp.tile_warp_cost_backward(*args)
    ref = tile_warp.tile_warp_cost_backward_plain(*args)
    terms, n = tile_warp.tile_warp_cost_backward_terms(args[0], args[1],
                                                      args[3])
    torch.cuda.synchronize()
    if any(a.dtype != torch.bfloat16 for a in got):
        fail(f"tile_warp_cost_backward bf16 {label}: dtypes "
             f"{[a.dtype for a in got]}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"tile_warp_cost_backward bf16 {label}: two launches differ")
    for n_, a, b in zip(("dhyp3", "dfea_l"), got[:2], ref[:2]):
        if not torch.equal(a, b):
            fail(f"tile_warp_cost_backward bf16 {label}: {n_} is not the "
                 "plain backward's bits")
    diff = (got[2].float() - ref[2].float()).abs()
    allow = 2.0 ** -7 * ref[2].float().abs() + n * 2.0 ** -24 * terms
    if not torch.isfinite(got[2]).all() or bool((diff > allow).any()):
        fail(f"tile_warp_cost_backward bf16 {label}: dfea_r beyond one bf16 "
             "ulp of its plain version")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    off = float((diff > 0).float().mean())
    if not quiet:
        print(f"  tile_warp_cost_backward bf16 {label}: dhyp3, dfea_l equal "
              f"in bits; dfea_r max |err| {float(diff.max()):.3e} (bound one "
              f"bf16 ulp + n 2^-24 of its sum of |terms|), off the plain "
              f"bits {off:.2e}; equal in bits on two launches", flush=True)
    return err, off


def tile_warp_backward_bf16_repeat(dev, launches: int = 4):
    """The bf16 backward at the training call (4 x 384x768, C=16) on
    tests/test_torch_gpu.py's random field (seed 0, disparities -20 to
    W + 20: taps past both edges), the case whose dfea_r took other bits
    from launch to launch while the row's sort ranked pixels by the order
    of shared-memory atomics: each of ``launches`` launches with dhyp3 and
    dfea_l equal in bits to the plain version, all three outputs equal in
    bits to the first launch's."""
    import torch
    from codd_torch.ops import tile_warp
    from codd_torch.tools.kernel_cutouts import training_call_inputs
    args = training_call_inputs(dev)
    ref = tile_warp.tile_warp_cost_backward_plain(*args)
    first = None
    for n in range(launches):
        got = tile_warp.tile_warp_cost_backward(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            fail(f"tile_warp_cost_backward bf16, training call, launch {n}: "
                 "dhyp3 or dfea_l is not the plain version's bits")
        if first is None:
            first = got
        elif not all(torch.equal(a, b) for a, b in zip(got, first)):
            fail(f"tile_warp_cost_backward bf16, training call, launch {n}: "
                 "not the first launch's bits")
    print(f"  tile_warp_cost_backward bf16, training call, taps past both "
          f"edges: {launches} launches, dhyp3 and dfea_l the plain "
          f"version's bits, all three outputs the first launch's", flush=True)


def tile_warp_backward_bf16(hyp3, smooth, fl, fr, gout, nbytes, flops):
    """Kernel 1's backward in bf16 (the VJP of the exact form) on phase 3's
    inputs rounded to bf16, the random and the smooth field at 384x1280,
    and at the training call (4 x 384x768, C=16, seeded on its own, the
    random field): against its plain bf16 version, timed, with the bound of
    half the f32 row's bytes."""
    import torch
    from codd_torch.ops import tile_warp
    bf = lambda *ts: [t.to(torch.bfloat16) for t in ts]  # noqa: E731
    g = torch.Generator().manual_seed(3)
    B4, h, w, C = 4, 384, 768, fl.shape[-1]
    dev = fl.device
    train = bf(torch.randn(B4, h // 4, w // 4, 48, generator=g).to(dev),
               torch.stack([torch.rand(B4, h // 4, w // 4, generator=g) * 192,
                            torch.rand(B4, h // 4, w // 4, generator=g) * 2
                            - 1,
                            torch.rand(B4, h // 4, w // 4, generator=g) * 2
                            - 1], -1).to(dev),
               torch.randn(B4, h, w, C, generator=g).to(dev),
               torch.randn(B4, h, w, C, generator=g).to(dev))
    from codd_torch.tools.kernel_cutouts import training_call_inputs
    # "edges": the training call with taps past both edges (kernel_cutouts'
    # inputs, those of MS_BEFORE)
    cases = {"random": bf(gout, hyp3, fl, fr),
             "smooth": bf(gout, smooth, fl, fr), "training call": train,
             "edges": training_call_inputs(dev)}
    errs, offs = zip(*(tile_warp_backward_bf16_compare(k, a)
                       for k, a in cases.items()))
    tile_warp_backward_bf16_repeat(dev)
    out = dict(max_abs_err_bf16=max(errs), unequal_share_bf16=max(offs))
    for key, k in (("ms_bf16", "random"), ("ms_bf16_smooth", "smooth"),
                   ("ms_bf16_train", "training call"),
                   ("ms_bf16_train_edges", "edges")):
        out[key] = cuda_ms(lambda: tile_warp.tile_warp_cost_backward(
            *cases[k]))
    out["plain_ms_bf16"] = cuda_ms(
        lambda: tile_warp.tile_warp_cost_backward_plain(*cases["random"]))
    out["bound_ms_bf16"], _ = bound_ms(nbytes / 2, flops)
    t = train
    out["bound_ms_bf16_train"], _ = bound_ms(
        2 * (2 * t[1].numel() + 4 * t[2].numel() + t[0].numel()),
        t[2].numel() // C * (36 * C + 10))
    before = MS_BEFORE["tile_warp_cost_backward_bf16"]
    print(f"  tile_warp_cost_backward bf16: {out['ms_bf16']:.4f} ms random "
          f"field, {out['ms_bf16_smooth']:.4f} smooth (bound "
          f"{out['bound_ms_bf16']:.4f}; ms_before {before['random']}, "
          f"{before['smooth']}, recorded), {out['ms_bf16_train']:.4f} at the "
          f"training call (bound {out['bound_ms_bf16_train']:.4f}), "
          f"{out['ms_bf16_train_edges']:.4f} with taps past both edges "
          f"(ms_before {before['training call']}, recorded); plain "
          f"{out['plain_ms_bf16']:.4f} ms", flush=True)
    return out


def gn_backward_compare(label, got, ref, terms, ae):
    """Kernel 5's backward against its plain version: each element within
    1e-5 of its sum of |terms| (f32 sums of ~2,300 pairs in another order,
    s recomputed in f32 by FMAs against the plain version's matrix
    products), plus the logits' rounding: three terms of size |a|^2
    cancel, and a logit off by d moves its pair's terms by at most d of
    themselves (8 ulp of 2 max|a|^2, as for the forward).  Returns the
    worst |err| / (sum of |terms|) and |err| / max|ref|."""
    import torch
    share = 1e-5 + 8 * 2.0 ** -24 * 2 * float((ae * ae).sum(-1).max())
    worst, worst_rel = 0.0, 0.0
    for name, a, b, t in zip(("dae", "dvals"), got, ref, terms):
        if not torch.isfinite(a).all():
            fail(f"gn_window_aggregate_backward ({label}): non-finite {name}")
        err = (a - b).abs()
        if bool((err > share * t + 1e-7).any()):
            fail(f"gn_window_aggregate_backward ({label}): {name} disagrees "
                 f"with its plain backward ({int((err > share * t + 1e-7).sum())}"
                 f" of {err.numel()} past {share:.2e} of the sum of |terms|)")
        worst = max(worst, float((err / (t + 1e-30)).max()))
        worst_rel = max(worst_rel, float(err.max() / b.abs().max()))
    return worst, worst_rel, share


def gn_backward_bf16_compare(label, got, ref, terms, ae):
    """Kernel 5's backward in its bf16-score form against its plain
    version: every element within one bf16 ulp (2^-7 of a value) of its
    sum of |terms| beyond the f32 form's bound (``gn_backward_compare``):
    each ordered pair's dS and each block sum of dvals is an f32 sum in
    another order rounded to bf16, which near a rounding boundary rounds
    the other way.  Returns (worst |err| / sum|terms|, the share of
    elements beyond the f32 bound, max |err|)."""
    import torch
    share = 1e-5 + 8 * 2.0 ** -24 * 2 * float((ae * ae).sum(-1).max())
    worst, beyond, n, err_max = 0.0, 0, 0, 0.0
    for name, a, b, t in zip(("dae", "dvals"), got, ref, terms):
        if not torch.isfinite(a).all():
            fail(f"gn_window_aggregate_backward_bf16 ({label}): non-finite "
                 f"{name}")
        err = (a - b).abs()
        over = err > (2.0 ** -7 + share) * t + 1e-7
        if bool(over.any()):
            fail(f"gn_window_aggregate_backward_bf16 ({label}): {name} "
                 f"disagrees with its plain backward ({int(over.sum())} of "
                 f"{err.numel()} past 2^-7 + {share:.2e} of the sum of "
                 "|terms|)")
        beyond += int((err > share * t + 1e-7).sum())
        n += err.numel()
        worst = max(worst, float((err / (t + 1e-30)).max()))
        err_max = max(err_max, float(err.max()))
    return worst, beyond / n, err_max


def gn_backward_attributes(bf16: bool):
    """(registers a thread, bytes spilled to local memory) of kernel 5's
    backward form, as cudaFuncGetAttributes reports them."""
    import ctypes
    from codd_torch.ops import kernels
    lib = kernels.load()["gn_window_aggregate_backward"]
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.gn_window_aggregate_backward_attributes(
        int(bf16), ctypes.byref(regs), ctypes.byref(local))
    if err:
        fail(f"gn_window_aggregate_backward_attributes: CUDA error {err}")
    return regs.value, local.value


def gn_backward_bf16_check(fields, g):
    """Kernel 5's backward in its bf16-score form at the motion stage's
    training call with a 1024-wide crop (B=4, 48x128 queries, where
    codd_tpu takes its windowed form) against its plain backward, on the
    ``random`` and the ``smooth`` embedding field (``fields``: name ->
    (ae, vals)), each twice for equal bits; its time on the random field,
    the plain version's, registers and spill, and the bound
    (``gn_backward_ops``)."""
    import torch
    from codd_torch.ops import gn
    out = dict(name="gn_window_aggregate_backward_bf16",
               source="codd_torch/csrc/gn_window.cu",
               replaces="codd_tpu/ops/gn.py:268", max_abs_err=0.0)
    for label, (ae, vals) in fields.items():
        got = gn.gn_window_aggregate_backward(g, ae, vals, bf16_scores=True)
        ref = gn.gn_window_aggregate_backward_plain(g, ae, vals,
                                                    bf16_scores=True)
        again = gn.gn_window_aggregate_backward(g, ae, vals,
                                                bf16_scores=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"gn_window_aggregate_backward_bf16 ({label}): two launches"
                 " on one input differ (the sums have a fixed order)")
        worst, beyond, err = gn_backward_bf16_compare(
            label, got, ref, gn.gn_window_aggregate_backward_terms(
                g, ae, vals, bf16_scores=True), ae)
        # the f32 form on the same inputs stands further off: the bf16
        # roundings are really taken
        f32 = gn.gn_window_aggregate_backward_plain(g, ae, vals)
        apart = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(f32, ref))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out[f"beyond_f32_share_{label}"] = beyond
        out[f"worst_over_terms_{label}"] = worst
        print(f"  gn_window_aggregate_backward_bf16 ({label}): worst |err| "
              f"/ sum|terms| {worst:.3e} (allowed 2^-7 + the f32 bound); "
              f"share beyond the f32 form's bound {beyond:.2e}; the plain "
              f"f32-score backward {apart:.2e} of max|ref| away; two "
              "launches equal in bits", flush=True)
        del got, ref, again, f32
        torch.cuda.empty_cache()
    ae, vals = fields["random"]
    B, h, w, C = ae.shape
    ky = np.minimum(np.arange(h) + 32, h - 1) - np.maximum(
        np.arange(h) - 32, 0) + 1
    kx = np.minimum(np.arange(w) + 32, w - 1) - np.maximum(
        np.arange(w) - 32, 0) + 1
    pairs = float(B * ky.sum() * kx.sum())
    out["ms"] = cuda_ms(lambda: gn.gn_window_aggregate_backward(
        g, ae, vals, bf16_scores=True))
    out["plain_ms"] = cuda_ms(lambda: gn.gn_window_aggregate_backward_plain(
        g, ae, vals, bf16_scores=True), warmup=1, iters=3)
    out["ms_f32_form"] = cuda_ms(lambda: gn.gn_window_aggregate_backward(
        g, ae, vals))
    out["registers"], out["spill_bytes"] = gn_backward_attributes(True)
    regs32, spill32 = gn_backward_attributes(False)
    print(f"  gn_window_aggregate_backward_bf16: {out['ms']:.4f} ms "
          f"(ms_before {MS_BEFORE['gn_window_aggregate_backward_bf16']['random']}"
          f" ms, recorded; the f32 form {out['ms_f32_form']:.4f} ms on the "
          f"same inputs), plain "
          f"{out['plain_ms']:.4f} ms; {pairs:.4g} pairs; {out['registers']} "
          f"registers, {out['spill_bytes']} bytes local (f32 form "
          f"{regs32}, {spill32})", flush=True)
    out.update(bytes=4 * B * h * w * (2 * C + 3 * 27),
               flops=gn_backward_ops(pairs, bf16_scores=True),
               library_ms=None)
    return out


def gn_backward_ops(pairs: float, bf16_scores: bool):
    """The operations of kernel 5's backward over ``pairs`` ordered pairs
    of windows, as (count, peak) pairs for ``bound_ms``.  s_ij, u_ij and
    the logit are symmetric, so each unordered pair takes the 32-wide
    logit dot, the 27-wide dots G_i.v_j and G_j.v_i, 27 dvals updates each
    way and 32 dae updates each way: 204 multiply-adds, 102 an ordered
    pair, with the logit, sigmoid and u (~10 operations, 5 an ordered
    pair) beside, on the CUDA cores.  The products need f32 accuracy:
    3xTF32 for the logits and U A; with bf16 scores, G_i.bf16(v_j) and
    bf16(s) G have an operand exact in bf16 (three bf16 products), with
    f32 scores 3xTF32 as well."""
    gv = F32_3XBF16_PER_S if bf16_scores else F32_3XTF32_PER_S
    return [(pairs * 2 * (16 + 32), F32_3XTF32_PER_S),
            (pairs * 2 * (27 + 27), gv), (pairs * 5, F32_FLOPS_PER_S)]


def gn_bf16_fields(randn, rand, dev):
    """The inputs of kernel 5's backward at the motion stage's training
    call with a 384x1024 crop (B=4, 48x128 queries, SceneFlow's
    intrinsics): the value field of a GN system, its cotangent, and two
    embedding fields at the model's scale (1/8): ``random`` (iid) and
    ``smooth`` (one direction plus a 0.05 ripple: logits near 0, so every
    pair of a window carries weight)."""
    import torch
    from codd_torch.ops import gn, se3
    from codd_torch.ops.projective import inv_project, project
    b, h, w = TRAIN_B, TRAIN_H // 8, 1024 // 8
    intr = torch.tensor([[1050.0 / 8, 1050.0 / 8, 512.0 / 8, 270.0 / 8]] * b,
                        device=dev)
    depth = rand(b, h, w, lo=2.0, hi=60.0)
    Ts = se3.exp(randn(b, h, w, 6, scale=0.01))
    target = (project(se3.act(Ts, inv_project(depth, intr)), intr)
              + randn(b, h, w, 3, scale=0.5))
    vals = gn.build_vals(Ts, target, rand(b, h, w, 3), depth,
                         intr).contiguous()
    fields = {"random": (randn(b, h, w, 32, scale=1.0 / 8).contiguous(),
                         vals),
              "smooth": ((randn(1, 1, 1, 32, scale=1.0 / 8)
                          + randn(b, h, w, 32, scale=0.05)).contiguous(),
                         vals)}
    return fields, randn(b, h, w, 27)


def gn_backward_check(ae, vals, g):
    """Kernel 5's backward at the motion stage's training call (B=4, 48x96,
    C=32, 27 values) against its plain backward, twice for equal bits; its
    time, the plain version's, and the bound: the operations the function
    needs (``gn_backward_ops``; dae_i = -2 (a_i sum_j u_ij - sum_j u_ij
    a_j)), the products as 3xTF32 on the tensor cores."""
    import torch
    from codd_torch.ops import gn
    got = gn.gn_window_aggregate_backward(g, ae, vals)
    ref = gn.gn_window_aggregate_backward_plain(g, ae, vals)
    again = gn.gn_window_aggregate_backward(g, ae, vals)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("gn_window_aggregate_backward: two launches on one input differ"
             " (the sums have a fixed order)")
    worst, worst_rel, share = gn_backward_compare(
        "phase 3", got, ref,
        gn.gn_window_aggregate_backward_terms(g, ae, vals), ae)
    B, h, w, C = ae.shape
    ky = np.minimum(np.arange(h) + 32, h - 1) - np.maximum(
        np.arange(h) - 32, 0) + 1
    kx = np.minimum(np.arange(w) + 32, w - 1) - np.maximum(
        np.arange(w) - 32, 0) + 1
    pairs = float(B * ky.sum() * kx.sum())
    print(f"  gn_window_aggregate_backward: worst |err| / sum|terms| "
          f"{worst:.3e} (allowed {share:.3e}); worst |err| / max|ref| "
          f"{worst_rel:.3e}; {pairs:.4g} pairs; two launches equal in bits")
    return dict(
        name="gn_window_aggregate_backward",
        source="codd_torch/csrc/gn_window.cu",
        replaces="codd_tpu/ops/gn.py:268", max_abs_err=max(
            float((a - b).abs().max()) for a, b in zip(got, ref)),
        ms=cuda_ms(lambda: gn.gn_window_aggregate_backward(g, ae, vals)),
        plain_ms=cuda_ms(lambda: gn.gn_window_aggregate_backward_plain(
            g, ae, vals)),
        # read ae, vals, G once; write dae, dvals once
        bytes=4 * B * h * w * (2 * C + 3 * 27),
        flops=gn_backward_ops(pairs, bf16_scores=False), library_ms=None)


def corr_patch_backward_terms(g, f1, levels, coords):
    """Each output's sum of |terms| for kernel 6's backward: the plain
    backward on |g|, |f1| and |levels| in f32, unrounded."""
    from codd_torch.ops import corr
    K = 49
    d1, dl = 0.0, []
    for i, l in enumerate(levels):
        a, b = corr.corr_patch_lookup_level_backward_plain(
            g[..., i * K:(i + 1) * K].abs(), f1.abs(), l.abs(),
            coords / 2 ** i, 3)
        d1 = d1 + a
        dl.append(b)
    return d1, dl


def corr_patch_backward_compare(label, got, ref, terms):
    """Kernel 6's backward against its plain version, in bf16: each element
    within one bf16 ulp of the larger of the two (both round f32 sums once;
    the sums run in another order, the levels' by atomics in a run-dependent
    order, so a sum next to a rounding boundary may round the other way)
    plus 1e-5 of its sum of |terms| (which covers the outputs that cancel
    to near 0).  Returns the worst error as a share of that allowance and
    the share of elements that differ."""
    import torch
    worst, differ, n = 0.0, 0, 0
    pairs = [(got[0], ref[0], terms[0])] + list(zip(got[1], ref[1], terms[1]))
    for i, (a, b, t) in enumerate(pairs):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"corr_patch_lookup_backward ({label}): non-finite output {i}")
        big = torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        err = (a - b).abs()
        allowed = ulp + 1e-5 * t
        if bool((err > allowed).any()):
            fail(f"corr_patch_lookup_backward ({label}): output {i} "
                 "disagrees with its plain backward")
        worst = max(worst, float((err / allowed).max()))
        differ += int((err > 0).sum())
        n += err.numel()
    return worst, differ / n


def patch_backward_adds(coords, shapes, radius=3):
    """Scalar f32 adds kernel 6's backward makes into the levels'
    gradients: a block (``PATCH_TILE`` queries, one level) adds once, a
    channel at a time in 16-byte atomics, to each pixel that one of its
    windows covers; counted as the distinct (block, pixel) pairs of the
    unmasked queries' taps."""
    import torch
    from codd_torch.ops import corr
    B, h, w = coords.shape[:3]
    th, tw = corr.PATCH_TILE
    t, P = 2 * radius + 2, 2 * radius + 1
    dev = coords.device
    nx = -(-w // tw)
    tile = ((torch.arange(h, device=dev)[:, None] // th) * nx
            + torch.arange(w, device=dev)[None, :] // tw).reshape(-1)
    tile = torch.arange(B, device=dev)[:, None] * (-(-h // th) * nx) + tile
    ar = torch.arange(t, device=dev)
    pairs = 0
    for i, (Hp, Wp) in enumerate(shapes):
        sy, sx, _, _, vq = corr._window_starts(coords / 2 ** i, Hp - 2 * P,
                                               Wp - 2 * P, radius)
        pix = ((sy[..., None, None] + ar[:, None]) * Wp
               + sx[..., None, None] + ar[None, :])
        key = tile[..., None, None] * (Hp * Wp) + pix
        pairs += int(torch.unique(key[vq].reshape(-1)).numel())
    return pairs * 128


def corr_patch_backward_check(pyr, fields, g):
    """Kernel 6's backward at the motion stage's training call (B=4, 48x96
    queries, four levels, C=128) against its plain backward on a smooth
    and a scattered field; its time (the smooth field's is the row's), the
    plain version's, the bound, the share of blocks whose box is one chunk
    and the global atomics (598.7 M scalar adds a call before the tiles
    were staged)."""
    import torch
    from codd_torch.ops import corr
    f1, levels = pyr["f1"], pyr["levels"]
    shapes = [tuple(l.shape[1:3]) for l in levels]
    ms, err, one, adds = {}, {}, {}, {}
    for fname, coords in fields.items():
        got = corr.corr_patch_lookup_backward(g, f1, levels, coords)
        ref = corr.corr_patch_lookup_backward_plain(g, f1, levels, coords)
        again = corr.corr_patch_lookup_backward(g, f1, levels, coords)
        torch.cuda.synchronize()
        if not torch.equal(got[0], again[0]):
            fail("corr_patch_lookup_backward: two launches give different "
                 "df1 (its sums have a fixed order)")
        ulps, share = corr_patch_backward_compare(
            f"phase 3, {fname}", got, ref,
            corr_patch_backward_terms(g, f1, levels, coords))
        pairs = [(got[0], ref[0])] + list(zip(got[1], ref[1]))
        err[fname] = max(float((a.float() - b.float()).abs().max())
                         for a, b in pairs)
        level_diff = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(got[1], again[1]))
        ms[fname] = cuda_ms(lambda: corr.corr_patch_lookup_backward(
            g, f1, levels, coords))
        plan = corr.patch_lookup_plan(coords, shapes, 3, backward=True)
        one[fname] = [round(float(p.float().mean()), 3) for p in plan]
        adds[fname] = patch_backward_adds(coords, shapes)
        print(f"  corr_patch_lookup_backward ({fname}): {ms[fname]:.4f} ms; "
              f"worst |err| {ulps:.3f} of the allowance (1 bf16 ulp + 1e-5 "
              f"of the sum of |terms|), {share:.2e} of the elements differ; "
              f"df1 equal in bits on two launches, the levels' gradients "
              f"apart by {level_diff:.3e} (atomics across blocks); blocks "
              f"whose box is one chunk, by level {one[fname]} (of "
              f"{plan[0].numel()} a level, {corr.PATCH_BWD_BOX_BYTES} B); "
              f"global atomics {adds[fname] / 1e6:.1f} M scalar adds "
              f"({adds[fname] / 4 / 1e6:.2f} M 16-byte atomicAdd), 598.7 M "
              "before")
    coords = fields["smooth"]
    B, h, w = coords.shape[:3]
    L = len(levels)
    valid = 0
    for i, l in enumerate(levels):
        P = 7
        *_, vq = corr._window_starts(coords / 2 ** i, l.shape[1] - 2 * P,
                                     l.shape[2] - 2 * P, 3)
        valid += int(vq.sum())
    print(f"  corr_patch_lookup_backward: {valid} of {B * h * w * L} "
          f"query-levels unmasked (smooth)")
    return dict(
        name="corr_patch_lookup_backward",
        source="codd_torch/csrc/corr_patch.cu",
        replaces="codd_tpu/ops/corr.py:208", max_abs_err=err["smooth"],
        ms=ms["smooth"], ms_scattered=ms["scattered"],
        one_chunk_share=one["smooth"], global_adds=adds["smooth"],
        plain_ms=cuda_ms(lambda: corr.corr_patch_lookup_backward_plain(
            g, f1, levels, coords)),
        # read f1, the levels (bf16), g, coords once; write df1 and the
        # levels' gradients (bf16) once
        bytes=float(4 * f1.numel() + 4 * sum(l.numel() for l in levels)
                    + 4 * g.numel() + 4 * coords.numel()),
        # a tap of an unmasked query-level: its bilinear transpose (~8),
        # 128 multiply-adds into df1, 128 products added into the level,
        # each an f32 cotangent times a bf16 feature (three bf16 products)
        flops=[(float(valid * 64 * 8), F32_FLOPS_PER_S),
               (float(valid * 64 * 4 * 128), F32_3XBF16_PER_S)],
        library_ms=None)


def corr_coords_backward_check(pyr, fields, g):
    """The lookup's coordinate gradient at the motion stage's training
    call (B=4, 48x96 queries, four levels) against its plain version on a
    smooth and a scattered field: each element within 1e-5 of its sum of
    |terms| (``corr_patch_lookup_coords_backward_terms``: the tap dots are
    f32 sums of 128 products in another order, and the derivative takes
    their differences); two launches equal in bits; its time (the smooth
    field's is the row's), the plain version's, and the bound: f1, the
    levels, g and the coordinates read once, the gradient written once;
    the tap dots of every unmasked query-level (bf16 products, at the
    tensor cores' peak as row 6 counts them) and the epilogue's 49 x 12
    f32 operations."""
    import torch
    from codd_torch.ops import corr
    f1, levels = pyr["f1"], pyr["levels"]
    ms, err, one = {}, {}, {}
    for fname, coords in fields.items():
        args = (g, f1, levels, coords)
        got = corr.corr_patch_lookup_coords_backward(*args)
        ref = corr.corr_patch_lookup_coords_backward_plain(*args)
        terms = corr.corr_patch_lookup_coords_backward_terms(*args)
        again = corr.corr_patch_lookup_coords_backward(*args)
        plan = corr.patch_lookup_plan(coords, [tuple(l.shape[1:3])
                                               for l in levels], 3,
                                      coords_grad=True)
        one[fname] = [round(float(p.float().mean()), 3) for p in plan]
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail("corr_patch_lookup_coords_backward: two launches differ in "
                 "bits (its sums have a fixed order)")
        if not torch.isfinite(got).all():
            fail("corr_patch_lookup_coords_backward: non-finite output")
        e = (got - ref).abs()
        share = float((e / (1e-5 * terms).clamp(min=1e-30)).max())
        if share > 1.0:
            fail(f"corr_patch_lookup_coords_backward ({fname}): disagrees "
                 f"with its plain version ({share:.3f} of its allowance)")
        err[fname] = float(e.max())
        ms[fname] = cuda_ms(lambda: corr.corr_patch_lookup_coords_backward(
            *args))
        print(f"  corr_patch_lookup_coords_backward ({fname}): "
              f"{ms[fname]:.4f} ms; "
              f"boxes of one chunk by level {one[fname]} "
              f"({corr.PATCH_COORDS_BOX_BYTES} B); "
              f"worst |err| {share:.3f} of its allowance "
              f"(1e-5 of the sum of |terms|), max |err| {err[fname]:.3e}, "
              f"max |ref| {float(ref.abs().max()):.3e}; equal in bits on two "
              "launches", flush=True)
    coords = fields["smooth"]
    valid = 0
    for i, l in enumerate(levels):
        *_, vq = corr._window_starts(coords / 2 ** i, l.shape[1] - 14,
                                     l.shape[2] - 14, 3)
        valid += int(vq.sum())
    return dict(
        name="corr_patch_lookup_coords_backward",
        source="codd_torch/csrc/corr_patch.cu",
        replaces="codd_tpu/ops/corr.py:208", max_abs_err=max(err.values()),
        ms=ms["smooth"], ms_scattered=ms["scattered"],
        one_chunk_share=one["smooth"],
        plain_ms=cuda_ms(lambda: corr.corr_patch_lookup_coords_backward_plain(
            g, f1, levels, coords)),
        bytes=float(2 * f1.numel() + 2 * sum(l.numel() for l in levels)
                    + 4 * g.numel() + 4 * coords.numel() * 2),
        flops=float(valid * 64 * 256 + coords[..., 0].numel() * len(levels)
                    * 49 * 12), peak=BF16_FLOPS_PER_S, library_ms=None)


def cuda_ms_cold(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn`` with the L2 cache cold: 256 MB written
    before each call, each call timed alone by its own CUDA events."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def corr_volume_backward_check(vols, fields, g):
    """Kernel 2b, the volume lookup's backward, at the motion stage's
    training call (B=4, 48x96 queries, four levels) against its plain
    backward, for both selects ("xla", corr_impl volume; "reduce",
    volume_reduce) on a smooth and a scattered field, in its two uses:
    dense (the VJP alone, into the wrapper's ``torch.zeros``) and adding
    into a running cotangent (the training step's, here a dense cotangent
    of another cotangent on the other field): the volumes' cotangents
    equal in bits (the same roundings in the same order; the running one
    also ``acc + dense`` in bits), the coordinates' each within 1e-5 of
    its sum of |terms| (``corr_lookup_coords_backward_terms``: the kernel
    sums a level's 49 products by rows, then the rows, the plain version
    in torch's order); two launches equal in bits.  Timed as the training
    step calls it, adding into a running cotangent (the row's ``ms``,
    smooth field, select "xla"; ``ms_cold`` with the L2 cache cold), and
    as the dense VJP with its ``torch.zeros`` (``ms_dense``).  The bound
    of the training call counts g, the coordinates and their gradient,
    the taps of every unmasked query-level read once and its window of
    the running cotangent read and written; the dense VJP's counts the
    dense cotangents (zeros included) written in place of the windows.
    The library call is grid_sample's backward on row 2's views."""
    import torch
    from codd_torch.ops import corr

    def bits(ts):
        return [t.view(torch.int16) for t in ts]

    ms, err = {}, {}
    for select in ("xla", "reduce"):
        for fname, coords in fields.items():
            other = next(c for k, c in fields.items() if k != fname)
            args = (g, vols, coords, 3, None, select)
            got = corr.corr_lookup_backward(*args)
            again = corr.corr_lookup_backward(*args)
            ref = corr.corr_lookup_backward_plain(*args)
            terms = corr.corr_lookup_coords_backward_terms(g, vols, coords)
            # a running cotangent: another call's dense cotangent
            run = corr.corr_lookup_backward_plain(g.flip(-1).contiguous(),
                                                  vols, other, 3, None,
                                                  select)[0]
            acc = [corr.corr_lookup_backward(
                *args, [r.clone() for r in run]) for _ in range(2)]
            ref_acc = corr.corr_lookup_backward_plain(
                *args, [r.clone() for r in run])
            torch.cuda.synchronize()
            label = f"corr_lookup_backward ({select}, {fname})"
            if not (all(torch.equal(a, b) for a, b in zip(
                    bits(got[0]), bits(again[0])))
                    and torch.equal(got[1], again[1])):
                fail(f"{label}: two launches differ in bits")
            unequal = [i for i, (a, b) in enumerate(zip(bits(got[0]),
                                                        bits(ref[0])))
                       if not torch.equal(a, b)]
            if unequal:
                fail(f"{label}: the volumes' cotangents of levels {unequal} "
                     "differ from the plain backward's bits")
            for i, (a, b, c, d, x) in enumerate(zip(
                    bits(acc[0][0]), bits(acc[1][0]), bits(ref_acc[0]),
                    ref[0], run)):
                if not (torch.equal(a, b) and torch.equal(a, c)
                        and torch.equal(a, (x + d).view(torch.int16))):
                    fail(f"{label}: level {i}'s running cotangent differs "
                         "between two launches, from the plain backward's "
                         "bits or from acc + dense")
            if not torch.equal(acc[0][1], got[1]):
                fail(f"{label}: the coordinates' gradient differs when "
                     "adding into a running cotangent")
            if not torch.isfinite(got[1]).all():
                fail(f"{label}: non-finite coordinate gradient")
            e = (got[1] - ref[1]).abs()
            share = float((e / (1e-5 * terms).clamp(min=1e-30)).max())
            if share > 1.0:
                fail(f"{label}: the coordinates' gradient disagrees with the "
                     f"plain version ({share:.3f} of its allowance)")
            err[(select, fname)] = float(e.max())
            ms[(select, fname)] = cuda_ms(
                lambda: corr.corr_lookup_backward(*args, run))
            ms[(select, fname, "dense")] = cuda_ms(
                lambda: corr.corr_lookup_backward(*args))
            print(f"  {label}: {ms[(select, fname)]:.4f} ms adding into a "
                  f"running cotangent, {ms[(select, fname, 'dense')]:.4f} "
                  f"ms dense (torch.zeros included); volumes' cotangents, "
                  f"dense and running, equal in bits to the plain "
                  f"backward's; coordinates' worst |err| {share:.3f} of its "
                  f"allowance (1e-5 of the sum of |terms|), max |err| "
                  f"{err[(select, fname)]:.3e}, max |ref| "
                  f"{float(ref[1].abs().max()):.3e}; equal in bits on two "
                  "launches", flush=True)
    coords = fields["smooth"]
    args = (g, vols, coords, 3, None, "xla")
    run = corr.corr_lookup_backward_plain(*args)[0]
    ms_cold = cuda_ms_cold(lambda: corr.corr_lookup_backward(*args, run))
    B, h, w = coords.shape[:3]
    valid = 0
    for i, v in enumerate(vols):
        *_, vq = corr._window_starts(coords / 2 ** i, v.shape[2] - 14,
                                     v.shape[3] - 14, 3)
        valid += int(vq.sum())
    dense = float(2 * sum(v.numel() for v in vols))
    # the nearest library call: grid_sample's backward (volume and grid)
    # on row 2's views, its output's cotangent g's level in bf16, one call
    # a level, timed alone
    lib = []
    for i, v in enumerate(vols):
        img, grid = _grid_sample_views(v, coords, i)
        go = (g.reshape(B * h * w, len(vols), 7, 7)[:, i:i + 1]
              .to(torch.bfloat16).contiguous())
        lib.append(cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            go, img, grid, 0, 0, True, [True, True])))
    print(f"  corr_lookup_backward: library (grid_sampler_2d_backward, bf16) "
          f"{sum(lib):.4f} ms = {' + '.join('%.4f' % t for t in lib)} by "
          f"level; the training call with the L2 cache cold {ms_cold:.4f} "
          f"ms; scattered field {ms[('xla', 'scattered')]:.4f} ms (dense "
          f"{ms[('xla', 'scattered', 'dense')]:.4f}); select reduce "
          f"{ms[('reduce', 'smooth')]:.4f} ms (dense "
          f"{ms[('reduce', 'smooth', 'dense')]:.4f}); the "
          f"{dense / 1e6:.0f} MB of dense cotangents the training call no "
          "longer makes", flush=True)
    inputs = 4 * g.numel() + 4 * coords.numel() * 2 + valid * 64 * 2
    flops = float(valid * (64 * 12 + 49 * 12))
    bound_dense, _ = bound_ms(inputs + dense, flops)
    return dict(
        name="corr_lookup_backward", source="codd_torch/csrc/corr_lookup.cu",
        replaces="codd_tpu/ops/corr.py:152",
        max_abs_err=max(err.values()), ms=ms[("xla", "smooth")],
        ms_cold=ms_cold, ms_scattered=ms[("xla", "scattered")],
        ms_dense=ms[("xla", "smooth", "dense")], bound_ms_dense=bound_dense,
        plain_ms=cuda_ms(lambda: corr.corr_lookup_backward_plain(
            *args, run)),
        bytes=float(inputs + 2 * valid * 64 * 2), flops=flops,
        library_ms=sum(lib))


def kernel_checks(dev):
    import torch
    from codd_torch.ops import corr, gn, se3, splat, tile_warp
    from codd_torch.ops.projective import inv_project, project
    from codd_torch.tools.kernel_cutouts import corr_fields

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
        row[f"unequal_share_bf16_{form}"] = unequal
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
    rows.append(tile_warp_backward_check(hyp3, fl, fr, randn(
        1, H // 4, W // 4, 48)))

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
            # the operations the function needs: each unordered pair's
            # 32-wide dot (64), logit (3) and sigmoid (3) once, as s is
            # symmetric, so 35 an ordered pair, and its own 27 FMAs (54),
            # the products as 3xTF32 on the tensor cores; per query: norm
            # (64) and, fused, the damped solve (~200)
            flops=[(pairs * (32 + 54), F32_3XTF32_PER_S),
                   (pairs * 3 + n * per_query, F32_FLOPS_PER_S)],
            library_ms=None))
        lb, _ = bound_ms(rows[-1]["bytes"], rows[-1]["flops"])
        bf_ms = cuda_ms(lambda: fn(ae, vals, bf16_scores=True))
        print(f"  {name}: {rows[-1]['ms']:.4f} ms = {rows[-1]['ms'] / lb:.2f} "
              f"x bound; bf16 scores {bf_ms:.4f} ms = {bf_ms / lb:.2f} x "
              f"bound; the tiling evaluates {evaluated:.0f} pairs for "
              f"{pairs:.0f} useful ({evaluated / pairs:.3f})")

    pyr = corr.build_corr_pyramid(f1, f2, 4, 3, impl="patch")
    rows.append(corr_patch_check(pyr, fields))

    # -- the backward of kernels 5 and 6 at the motion stage's training
    # calls: B=4, 384x768 frames, 48x96 queries (SceneFlow's intrinsics) --
    tb, th, tw = TRAIN_B, TRAIN_H // 8, TRAIN_W // 8
    intr8t = torch.tensor([[1050.0 / 8, 1050.0 / 8, 480.0 / 8, 270.0 / 8]]
                          * tb, device=dev)
    depth = rand(tb, th, tw, lo=2.0, hi=60.0)
    Ts = se3.exp(randn(tb, th, tw, 6, scale=0.01))
    target = (project(se3.act(Ts, inv_project(depth, intr8t)), intr8t)
              + randn(tb, th, tw, 3, scale=0.5))
    tvals = gn.build_vals(Ts, target, rand(tb, th, tw, 3), depth,
                          intr8t).contiguous()
    tae = randn(tb, th, tw, 32, scale=1.0 / 8).contiguous()
    rows.append(gn_backward_check(tae, tvals, randn(tb, th, tw, 27)))
    rows.append(gn_backward_bf16_check(*gn_bf16_fields(randn, rand, dev)))
    tf1, tf2 = randn(tb, th, tw, 128), randn(tb, th, tw, 128)
    tfields = {k: torch.cat([v] * tb).contiguous() for k, v in corr_fields(
        randn(1, th, tw, 2, scale=6.0), th, tw, dev).items()}
    tpyr = corr.build_corr_pyramid(tf1, tf2, 4, 3, impl="patch")
    tg = randn(tb, th, tw, 4 * 49)
    rows.append(corr_patch_backward_check(tpyr, tfields, tg))
    rows.append(corr_coords_backward_check(tpyr, tfields, tg))
    del tpyr
    tvols = corr.build_corr_pyramid(tf1, tf2, 4, 3)
    rows.append(corr_volume_backward_check(tvols, tfields, tg))
    del tvols
    torch.cuda.empty_cache()

    # -- kernel 4's backward at the joint stage's two training calls, one
    # image of B=4 each: full res 384x768 (C=6, r=1; the row's time) and
    # quarter res 96x192 (C=32, r=2), built as the motion module builds
    # them, SceneFlow's intrinsics --
    intr_t = torch.tensor([[1050.0, 1050.0, 480.0, 270.0]], device=dev)
    depth = rand(1, TRAIN_H, TRAIN_W, lo=2.0, hi=60.0)
    Ts = se3.exp(randn(1, TRAIN_H, TRAIN_W, 6, scale=0.01))
    X2 = se3.act(Ts, inv_project(depth, intr_t)).reshape(-1, 3)
    hq, wq = TRAIN_H // 4, TRAIN_W // 4
    X2q = se3.act(Ts[:, 1::4, 1::4], inv_project(depth[:, 1::4, 1::4],
                                                 intr_t / 4)).reshape(-1, 3)
    bfull = splat_backward_check(
        f"full res {TRAIN_H}x{TRAIN_W}, C=6, r=1", X2, intr_t[0], TRAIN_H,
        TRAIN_W, 1.0, randn(TRAIN_H * TRAIN_W, 6),
        randn(TRAIN_H * TRAIN_W, 6), randn(TRAIN_H * TRAIN_W))
    bquarter = splat_backward_check(
        f"quarter res {hq}x{wq}, C=32, r=2", X2q, intr_t[0] / 4, hq, wq, 2.0,
        randn(hq * wq, 32), randn(hq * wq, 32), randn(hq * wq))
    rows.append(dict(
        name="splat_composite_backward",
        source="codd_torch/csrc/splat_composite.cu",
        replaces="codd_tpu/ops/splat.py:76",
        max_abs_err=max(bfull["err"], bquarter["err"]), ms=bfull["ms"],
        plain_ms=bfull["plain_ms"], bytes=bfull["bytes"],
        flops=bfull["flops"], library_ms=None, ms_quarter=bquarter["ms"],
        bound_ms_quarter=bquarter["bound_ms"]))

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

def frames(n: int, dev, seed: int = 1, h: int = H, w: int = W):
    """Seeded stereo frames (h x w) of a smooth textured plane: the right
    view is the left one shifted by 8 + t whole pixels (disparity 8 + t),
    and the camera pans 2 pixels a frame."""
    import torch
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((1, 3, h // 8, (w + 64) // 8), generator=g)
    tex = torch.nn.functional.interpolate(base, size=(h, w + 64),
                                          mode="bilinear", align_corners=False)
    tex = tex + 0.1 * torch.rand(tex.shape, generator=g)
    out = []
    for t in range(n):
        left = tex[..., 2 * t:2 * t + w]
        shift = 8 + t  # whole-pixel shift keeps the right view exact
        right = tex[..., 2 * t + shift:2 * t + shift + w]
        out.append((left.permute(0, 2, 3, 1).contiguous().to(dev),
                    right.permute(0, 2, 3, 1).contiguous().to(dev)))
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the six hot ops to their plain PyTorch versions (phase 6)."""
    import torch
    from codd_torch.models.stereo import hitnet
    from codd_torch.ops import corr, gn, splat, tile_warp

    def corr_plain(vols, coords, radius=3, scales=None, out=None, offset=0,
                   select="xla"):   # the forward of every select
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


def model_cfg(name: str = "codd.py", **overrides):
    """The ``model`` dict of configs/models/<name>; ``overrides`` replace
    its top-level keys."""
    from codd_torch.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "configs"
                          / "models" / name))
    return dict(cfg["model"], **overrides)


def build_model(name: str = "codd.py", **overrides):
    """A model of configs/models/<name> on the card, seeded weights."""
    from codd_torch.models.builder import build_estimator

    return build_estimator(model_cfg(name, **overrides), device="cuda",
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

    expect = dict(dict.fromkeys(kernels.KERNELS, 0),
                  tile_warp_cost=9 * (steps + 1), corr_lookup=16 * steps,
                  gn_fused_solve=16 * steps, splat_composite=2 * steps)
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
    from codd_torch.ops import kernels
    esteps = EVAL_FRAMES - 1
    tile = 9 * EVAL_FRAMES
    zero = dict.fromkeys(kernels.KERNELS, 0)
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


# ---------------------------------------------------------------------------
# train: the training step of the stereo and the fusion stage
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_W = 4, 2, 384, 768
TRAIN_STEPS = 5


def train_batches(n: int, dev, seed: int = 7):
    """``n`` seeded synthetic batches at SceneFlow's training shape (B=4,
    T=2, the 384x768 crop): images uniform in [0, 1), ground-truth
    disparity uniform in (1, 210), SceneFlow's intrinsics; made on the
    host in bulk and moved to the card before the steps."""
    import torch
    g = torch.Generator().manual_seed(seed)
    shape = (TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_W)
    out = []
    for _ in range(n):
        out.append({
            "l_img": torch.rand(shape + (3,), generator=g),
            "r_img": torch.rand(shape + (3,), generator=g),
            "gt_disp": torch.rand(shape + (1,), generator=g) * 209 + 1,
            "intrinsics": torch.tensor([[1050.0, 1050.0, 480.0, 270.0]]
                                       * TRAIN_B)})
    return [{k: v.to(dev) for k, v in b.items()} for b in out]


def motion_batches(n: int, dev, seed: int = 11, w: int = TRAIN_W):
    """``n`` seeded batches for the motion stage at SceneFlow's training
    shape (B=4, T=2, 384x768; ``w`` another crop width): each clip is
    ``frames()``' panning plane,
    so the ground truth is in closed form: disparity 8 + t, flow (-2, 0)
    towards the next frame, disparity change +1; SceneFlow's
    intrinsics."""
    import torch
    out = []
    for i in range(n):
        clips = [frames(TRAIN_T, "cpu", seed * 1000 + i * TRAIN_B + b,
                        TRAIN_H, w) for b in range(TRAIN_B)]
        side = lambda k: torch.cat([torch.stack(  # noqa: E731
            [f[k] for f in c], 1) for c in clips])
        shape = (TRAIN_B, TRAIN_T, TRAIN_H, w)
        flow = torch.zeros(shape + (2,))
        flow[..., 0] = -2.0
        out.append({
            "l_img": side(0), "r_img": side(1),
            "gt_disp": (8.0 + torch.arange(TRAIN_T, dtype=torch.float32)
                        ).reshape(1, TRAIN_T, 1, 1, 1).expand(
                            shape + (1,)).contiguous(),
            "gt_flow": flow, "gt_disp_change": torch.ones(shape + (1,)),
            "intrinsics": torch.tensor([[1050.0, 1050.0, 480.0, 270.0]]
                                       * TRAIN_B)})
    return [{k: v.to(dev) for k, v in b.items()} for b in out]


@contextlib.contextmanager
def recorded(module, name, replacement=None):
    """``module.name`` as the model calls it, replaced by ``replacement``
    where given (a plain version, say); yields the inputs of every call."""
    real, kept = getattr(module, name), []

    def keep(*args):
        kept.append(args)
        return (replacement or real)(*args)

    setattr(module, name, keep)
    try:
        yield kept
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def motion_backwards(gn_bwd=None, corr_bwd=None):
    """The backward of kernels 5 and 6 as the model's Functions call them,
    replaced by ``gn_bwd`` / ``corr_bwd`` where given; yields the inputs
    of every call, by kernel."""
    from codd_torch.ops import corr, gn
    with recorded(gn, "gn_window_aggregate_backward", gn_bwd) as g, \
            recorded(corr, "corr_patch_lookup_backward", corr_bwd) as c:
        yield {"gn": g, "corr": c}


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and ATen's (``index_add_`` and
    the scatters sorted instead of atomic; warnings only where an op has
    none)."""
    import warnings
    import torch
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            old[:2]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])


def run_to_run(label, model, lc, batch, cases):
    """Traced, not gated: each case's one-batch gradients twice, and how
    far apart the two runs are (the worst tensor's |diff| / |norm|, a norm
    counted as at least 1e-5 of the largest, and the worst 3 tensors).
    ``cases``: (name, a function returning the case's context)."""
    print(f"  {label}, one batch run twice in each configuration "
          "(run-to-run, traced):", flush=True)
    res = {}
    for name, ctx in cases:
        runs = []
        for _ in range(2):
            with ctx():
                runs.append(stage_grads(model, lc, batch)[1])
        print(f"    {name}:", flush=True)
        res[name] = grads_apart(runs[0], runs[1], 1e-5, show=3)[0]
        print(f"      worst {res[name]:.2e}", flush=True)
    return res


def motion_grad_checks(model, lc, batch, trace=False):
    """One batch of the motion stage, gradients only, no update.  Gated:
    each of the step's 16 calls of both backward kernels against its plain
    backward on the same inputs (phase 3's tolerances); the whole batch's
    gradients with only those two backward kernels swapped for their plain
    versions (every forward kernel kept): each parameter's gradient within
    1e-3 of its norm, the loss equal to 1e-6.  Gradients that vanish by
    invariance (the biases in front of fnet's instance norms; the ae
    head's bias, which every logit difference cancels) are f32 noise of
    ~1e-9 against a largest norm of ~10, so a norm is taken as at least
    1e-5 of the largest.  Reported: the same run with the kernels again
    (the atomics' run-to-run order); with ``trace``, ``run_to_run`` in six
    configurations (each backward kernel alone, deterministic cuDNN and
    ATen)."""
    import torch
    from codd_torch.ops import corr, gn
    with motion_backwards() as kept:
        lk, gk, _ = stage_grads(model, lc, batch)
    if len(kept["gn"]) != 16 or len(kept["corr"]) != 16:
        fail(f"motion stage: {len(kept['gn'])} / {len(kept['corr'])} calls "
             "of the backward of kernels 5 / 6 in one batch, not 16 / 16")
    gw = gr = gu = cu = cs = 0.0
    for i, (g, ae, vals, radius, bf16) in enumerate(kept["gn"]):
        if bf16:
            fail("motion stage: kernel 5's backward took the bf16-score "
                 "form with f32 scores")
        with torch.no_grad():
            got = gn.gn_window_aggregate_backward(g, ae, vals, radius)
            ref = gn.gn_window_aggregate_backward_plain(g, ae, vals, radius)
            terms = gn.gn_window_aggregate_backward_terms(g, ae, vals,
                                                          radius)
            w, r, sh = gn_backward_compare(f"call {i} of a motion step", got,
                                           ref, terms, ae)
        gw, gr, gu = max(gw, w), max(gr, r), max(gu, sh)
    for i, (g, f1, levels, coords, radius, scales) in enumerate(kept["corr"]):
        with torch.no_grad():
            got = corr.corr_patch_lookup_backward(g, f1, levels, coords)
            ref = corr.corr_patch_lookup_backward_plain(g, f1, levels, coords)
            u, d = corr_patch_backward_compare(
                f"call {i} of a motion step", got, ref,
                corr_patch_backward_terms(g, f1, levels, coords))
        cu, cs = max(cu, u), max(cs, d)
    print(f"  motion stage, one batch: the backward of kernels 5 and 6 on "
          f"the step's 16 calls each, against their plain backward on the "
          f"same inputs: kernel 5 worst |err| / sum|terms| {gw:.3e} "
          f"(allowed {gu:.3e}), |err| / max|ref| {gr:.3e}; kernel 6 worst "
          f"|err| {cu:.3f} of its allowance (1 bf16 ulp + 1e-5 of the sum of "
          f"|terms|), up to {cs:.2e} of the elements differ", flush=True)
    del kept
    print(f"  motion stage, one batch, {len(gk)} gradient tensors against "
          f"the kernels' own (loss {lk:.6f}):", flush=True)
    res = {}
    for label, plain in (("kernels again", False),
                         ("plain backward of kernels 5 and 6 (bound 1e-3, "
                          "loss 1e-6)", True)):
        with motion_backwards(
                gn.gn_window_aggregate_backward_plain if plain else None,
                corr.corr_patch_lookup_backward_plain if plain else None):
            lx, gx, _ = stage_grads(model, lc, batch)
        err, where = grads_apart(gk, gx, 1e-5, show=4)
        res[plain] = (abs(lk - lx) / abs(lx), err, set(gx) == set(gk))
        print(f"    {label}: loss {lx:.6f} (rel {res[plain][0]:.2e}), worst "
              f"gradient |diff| / |plain| {err:.2e} at {where}", flush=True)
    lb, eb, same = res[True]
    if not same or eb > 1e-3 or lb > 1e-6:
        fail("motion stage: the gradients with the backward kernels disagree "
             "with those of their plain backward")
    if any(k.startswith("stereo.") for k in gk):
        fail("motion stage: a frozen stereo parameter has a gradient")
    if not trace:
        return
    gp, cp = gn.gn_window_aggregate_backward_plain, \
        corr.corr_patch_lookup_backward_plain

    def both(gb, cb, det):
        @contextlib.contextmanager
        def ctx():
            with motion_backwards(gb, cb), (deterministic() if det else
                                            contextlib.nullcontext()):
                yield
        return ctx

    run_to_run("motion stage", model, lc, batch, [
        ("both backward kernels", both(None, None, False)),
        ("both backward kernels, deterministic cuDNN and ATen",
         both(None, None, True)),
        ("kernel 5's backward alone (6b plain), deterministic",
         both(None, cp, True)),
        ("kernel 6's backward alone (5b plain), deterministic",
         both(gp, None, True)),
        ("both plain, deterministic", both(gp, cp, True)),
        ("both plain", both(gp, cp, False))])


def volume_cotangent_ops(model, lc, batch):
    """One batch's gradients (``stage_grads``) under torch.profiler, host
    ops with their shapes: the fills (``aten::zero_``) and the adds
    (``aten::add`` / ``add_``) of tensors as large as a volume of the
    pyramid, the dense volume cotangents made and summed over the GN
    iterations (shaped as the volume, or with its plane flat as the plain
    backward makes it)."""
    from torch.profiler import ProfilerActivity, profile

    from codd_torch.ops import corr
    shapes, real = set(), corr.build_corr_pyramid

    def build(*args, **kwargs):
        vols = real(*args, **kwargs)
        for v in vols:
            B, N, Hp, Wp = v.shape
            shapes.update({(B, N, Hp, Wp), (B, N, Hp * Wp)})
        return vols

    corr.build_corr_pyramid = build
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as p:
            stage_grads(model, lc, batch)
    finally:
        corr.build_corr_pyramid = real

    def count(names):
        return sum(1 for e in p.events() if e.name in names and e.input_shapes
                   and tuple(e.input_shapes[0]) in shapes)

    return count(("aten::zero_",)), count(("aten::add", "aten::add_"))


def volume_motion_checks(model, lc, batch):
    """One batch of the motion stage with ``corr_impl="volume"`` (the
    lookup through the volume pyramid, kernel 2b in the backward),
    gradients only, no update.  Gated: the batch's backward fills one
    running cotangent (a ``zero_`` a level) and adds no tensor shaped as a
    volume (``volume_cotangent_ops``); 2b's 16 calls all add into that one
    running cotangent; on each call's inputs the dense VJP is the plain
    backward's (phase 3's rules: volumes' cotangents in bits,
    coordinates' within 1e-5 of the sum of |terms|); what reaches the
    volumes' matmul (the ``VolumeCarry``'s gradient) is, in bits, the
    in-order bf16 sum of the 16 calls' plain dense cotangents; the
    batch's gradients with 2b swapped for its plain backward (every other
    kernel kept): each parameter's within 1e-3 of its norm (a norm
    counted as at least 1e-5 of the largest), the loss to 1e-6."""
    import torch
    from codd_torch.ops import corr
    fills, adds = volume_cotangent_ops(model, lc, batch)
    print(f"  volume motion stage, one batch's backward: {fills} fills and "
          f"{adds} adds of tensors shaped as a volume", flush=True)
    if (fills, adds) != (4, 0):
        fail(f"volume motion stage: the backward fills {fills} and adds "
             f"{adds} volume-shaped tensors, not one running cotangent (4 "
             "and 0)")
    arrived, real_build = [], corr.build_corr_pyramid

    def build(*args, **kwargs):
        vols = real_build(*args, **kwargs)
        vols[0].grad_fn.register_hook(
            lambda gi, go: arrived.append(list(gi)))
        return vols

    corr.build_corr_pyramid = build
    try:
        with recorded(corr, "corr_lookup_backward") as kept:
            lk, gk, _ = stage_grads(model, lc, batch)
    finally:
        corr.build_corr_pyramid = real_build
    iters = model.motion.raft3d.iters
    if len(kept) != iters or len(arrived) != 1:
        fail(f"volume motion stage: {len(kept)} calls of kernel 2b and "
             f"{len(arrived)} volume cotangents in one batch, not {iters} "
             "and 1")
    if any(args[6] is None or args[6] is not kept[0][6] for args in kept):
        fail("volume motion stage: the 16 calls of kernel 2b do not add "
             "into one running cotangent")
    worst, total = 0.0, None
    for i, (g, vols, coords, radius, scales, select, _) in enumerate(kept):
        with torch.no_grad():
            got = corr.corr_lookup_backward(g, vols, coords, radius, scales,
                                            select)
            ref = corr.corr_lookup_backward_plain(g, vols, coords, radius,
                                                  scales, select)
            terms = corr.corr_lookup_coords_backward_terms(g, vols, coords,
                                                           radius, scales)
        if select != "xla" or not all(
                torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(got[0], ref[0])):
            fail(f"volume motion stage: call {i} of kernel 2b (select "
                 f"{select}) differs from its plain backward's bits")
        worst = max(worst, float(((got[1] - ref[1]).abs()
                                  / (1e-5 * terms).clamp(min=1e-30)).max()))
        total = ref[0] if total is None else [
            t + d for t, d in zip(total, ref[0])]
        del got, ref
    if worst > 1.0:
        fail(f"volume motion stage: kernel 2b's coordinate gradient "
             f"{worst:.3f} of its allowance")
    if not all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(arrived[0], total)):
        fail("volume motion stage: the cotangent that reaches the volumes' "
             "matmul is not the in-order bf16 sum of the 16 plain dense "
             "cotangents")
    del kept, arrived, total
    with recorded(corr, "corr_lookup_backward",
                  corr.corr_lookup_backward_plain):
        lx, gx, _ = stage_grads(model, lc, batch)
    err, where = grads_apart(gk, gx, 1e-5, show=4)
    rel_loss = abs(lk - lx) / abs(lx)
    print(f"  volume motion stage, one batch: kernel 2b's 16 calls add into "
          f"one running cotangent; on each call's inputs its dense VJP "
          f"equals the plain backward's bits, coordinates' worst "
          f"{worst:.3f} of the allowance; the cotangent reaching the "
          f"volumes' matmul is the in-order bf16 sum of the 16 plain dense "
          f"cotangents, in bits; the batch's {len(gk)} gradients with 2b's "
          f"plain backward (bound 1e-3, loss 1e-6): loss {lx:.6f} (rel "
          f"{rel_loss:.2e}), worst |diff| / |plain| {err:.2e} at {where}",
          flush=True)
    if set(gx) != set(gk) or err > 1e-3 or rel_loss > 1e-6:
        fail("volume motion stage: the gradients with kernel 2b disagree "
             "with those of its plain backward")
    if any(k.startswith("stereo.") for k in gk):
        fail("volume motion stage: a frozen stereo parameter has a gradient")


def bf16_scores_motion_checks(model, lc, batch):
    """One batch of the motion stage with ``gn_bf16_scores`` at a 1024-wide
    crop (48x128 GN fields, where codd_tpu scores in bf16 on its windowed
    form), gradients only, no update.  Gated: kernel 5's backward in its
    bf16-score form on each of the step's 16 calls against its plain
    backward (phase 3's rule: one bf16 ulp of the sum of |terms| beyond
    the f32 bound), twice for equal bits; the batch's gradients with it
    swapped for its plain backward (every forward kernel kept): each
    parameter's within 1e-3 of its norm (a norm counted as at least 1e-5
    of the largest), the loss to 1e-6."""
    import torch
    from codd_torch.ops import gn
    with recorded(gn, "gn_window_aggregate_backward") as kept:
        lk, gk, _ = stage_grads(model, lc, batch)
    if len(kept) != 16 or not all(k[4] is True for k in kept):
        fail(f"bf16-score motion stage: {len(kept)} calls of kernel 5's "
             "backward in one batch, not 16 in the bf16-score form")
    worst, beyond = 0.0, 0.0
    for i, (g, ae, vals, radius, bf16) in enumerate(kept):
        with torch.no_grad():
            got = gn.gn_window_aggregate_backward(g, ae, vals, radius, bf16)
            again = gn.gn_window_aggregate_backward(g, ae, vals, radius,
                                                    bf16)
            ref = gn.gn_window_aggregate_backward_plain(g, ae, vals, radius,
                                                        bf16)
            terms = gn.gn_window_aggregate_backward_terms(g, ae, vals,
                                                          radius, bf16)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"bf16-score motion stage: call {i} of kernel 5's "
                     "backward differs between two launches")
            w, sh, _ = gn_backward_bf16_compare(
                f"call {i} of a motion step", got, ref, terms, ae)
        worst, beyond = max(worst, w), max(beyond, sh)
    del kept
    with recorded(gn, "gn_window_aggregate_backward",
                  gn.gn_window_aggregate_backward_plain):
        lx, gx, _ = stage_grads(model, lc, batch)
    err, where = grads_apart(gk, gx, 1e-5, show=4)
    rel_loss = abs(lk - lx) / abs(lx)
    print(f"  bf16-score motion stage, one batch: kernel 5's bf16-score "
          f"backward on the step's 16 calls against its plain backward: "
          f"worst |err| / sum|terms| {worst:.3e}, share beyond the f32 "
          f"bound up to {beyond:.2e}, two launches equal in bits; the "
          f"batch's {len(gk)} gradients with its plain backward (bound "
          f"1e-3, loss 1e-6): loss {lx:.6f} (rel {rel_loss:.2e}), worst "
          f"|diff| / |plain| {err:.2e} at {where}", flush=True)
    if set(gx) != set(gk) or err > 1e-3 or rel_loss > 1e-6:
        fail("bf16-score motion stage: the gradients with kernel 5's "
             "bf16-score backward disagree with those of its plain backward")
    if any(k.startswith("stereo.") for k in gk):
        fail("bf16-score motion stage: a frozen stereo parameter has a "
             "gradient")


def joint_grad_checks(label, model, lc, batch, stereo_frozen=True,
                      trace=False):
    """One batch of a joint stage, gradients only, no update.  Gated:
    kernel 4's backward on each of the step's 8 calls (two splats an
    image) against its plain backward (phase 3's tolerance), and with the
    stereo trained the coordinate gradient on each of its 16 calls (one a
    GN iteration) against its plain version; the whole batch's gradients
    with those backward kernels swapped for their plain versions (every
    other kernel kept): each parameter's gradient within 1e-3 of its norm
    (a norm counted as at least 1e-5 of the largest, as in the motion
    stage), the loss equal to 1e-6; with the stereo frozen, no stereo
    parameter has a gradient and the coordinate gradient never runs.
    With ``trace``: run to run, with and without deterministic cuDNN and
    ATen, and with kernel 4's backward the only backward kernel."""
    import torch
    from codd_torch.ops import corr, gn, splat
    with recorded(splat, "composite_backward") as kept, \
            recorded(corr, "corr_patch_lookup_coords_backward") as kept_c:
        lk, gk, _ = stage_grads(model, lc, batch)
    if len(kept) != 2 * TRAIN_B:
        fail(f"{label}: {len(kept)} calls of kernel 4's backward in one "
             f"batch, not {2 * TRAIN_B}")
    want_c = 0 if stereo_frozen else model.motion.raft3d.iters
    if len(kept_c) != want_c:
        fail(f"{label}: {len(kept_c)} calls of the coordinate gradient in "
             f"one batch, not {want_c}")
    worst_c = 0.0
    for i, args in enumerate(kept_c):
        with torch.no_grad():
            got = corr.corr_patch_lookup_coords_backward(*args)
            ref = corr.corr_patch_lookup_coords_backward_plain(*args)
            terms = corr.corr_patch_lookup_coords_backward_terms(*args)
        share = float(((got - ref).abs() / (1e-5 * terms).clamp(min=1e-30))
                      .max())
        if not torch.isfinite(got).all() or share > 1.0:
            fail(f"{label}: the coordinate gradient of call {i} disagrees "
                 f"with its plain version ({share:.3f} of its allowance)")
        worst_c = max(worst_c, share)
    if kept_c:
        print(f"  {label}, one batch: the coordinate gradient on the step's "
              f"{len(kept_c)} calls against its plain version on the same "
              f"inputs: worst |err| {worst_c:.3f} of its allowance (1e-5 of "
              "the sum of |terms|)", flush=True)
    del kept_c
    worst = 0.0
    for i, args in enumerate(kept):
        with torch.no_grad():
            got = splat.composite_backward(*args)
            ref = splat.composite_backward_plain(*args)
            terms = splat.composite_backward_terms(*args)
        for name, a, b, t in zip(("dfeat", "dalpha", "dz"), got, ref, terms):
            share = float(((a - b).abs() / (1e-5 * t + SPLAT_FLOOR)).max())
            if not torch.isfinite(a).all() or share > 1.0:
                fail(f"{label}: kernel 4's backward, {name} of call {i}, "
                     f"disagrees with its plain backward (worst |err| "
                     f"{share:.3f} of its allowance)")
            worst = max(worst, share)
    print(f"  {label}, one batch: kernel 4's backward on the step's "
          f"{len(kept)} calls (C {sorted({a[3].shape[1] for a in kept})}) "
          f"against its plain backward on the same inputs: worst |err| "
          f"{worst:.3f} of its allowance (1e-5 of the sum of |terms| + "
          "2^-122)", flush=True)
    del kept
    with recorded(splat, "composite_backward",
                  splat.composite_backward_plain), \
            recorded(corr, "corr_patch_lookup_coords_backward",
                     corr.corr_patch_lookup_coords_backward_plain):
        lx, gx, _ = stage_grads(model, lc, batch)
    err, where = grads_apart(gk, gx, 1e-5, show=4)
    loss_err = abs(lk - lx) / abs(lx)
    print(f"  {label}, one batch, {len(gk)} gradient tensors (loss "
          f"{lk:.6f}); kernel 4's plain backward"
          f"{'' if stereo_frozen else ' and the plain coordinate gradient'}"
          f" (bound 1e-3, loss 1e-6): loss rel {loss_err:.2e}, worst "
          f"gradient |diff| / |plain| {err:.2e} at {where}", flush=True)
    if set(gx) != set(gk) or err > 1e-3 or loss_err > 1e-6:
        fail(f"{label}: the gradients with the new backward kernels disagree "
             "with those of their plain versions")
    if stereo_frozen and any(k.startswith("stereo.") for k in gk):
        fail(f"{label}: a frozen stereo parameter has a gradient")
    if not stereo_frozen and not any(k.startswith("stereo.") for k in gk):
        fail(f"{label}: the trained stereo has no gradient")
    if not trace:
        return
    gp, cp = gn.gn_window_aggregate_backward_plain, \
        corr.corr_patch_lookup_backward_plain

    def case(plain_others, det):
        @contextlib.contextmanager
        def ctx():
            with motion_backwards(*((gp, cp) if plain_others
                                    else (None, None))), \
                    (deterministic() if det else contextlib.nullcontext()):
                yield
        return ctx

    run_to_run(label, model, lc, batch, [
        ("every backward kernel", case(False, False)),
        ("every backward kernel, deterministic cuDNN and ATen",
         case(False, True)),
        ("kernel 4's backward alone (5b, 6b plain), deterministic",
         case(True, True))])


@contextlib.contextmanager
def tile_warp_halves(forward: str, backward: str, nudge: bool = False):
    """Kernel 1 in the model's place with each half, ``forward`` and
    ``backward``, the kernel ("kernel") or its plain version ("plain").
    With ``nudge``, each forward output moves one ulp up or down (a seeded
    coin a value), the size of the kernel's difference from its plain
    version."""
    import torch
    coins = torch.Generator(device="cuda" if torch.cuda.is_available()
                            else "cpu").manual_seed(5)
    from codd_torch.models.stereo import hitnet
    from codd_torch.ops import tile_warp as tw
    fwd = {"kernel": tw.tile_warp_cost,
           "plain": tw.tile_warp_cost_plain}[forward]
    bwd = {"kernel": tw.tile_warp_cost_backward,
           "plain": tw.tile_warp_cost_backward_plain}[backward]

    class Halves(torch.autograd.Function):
        @staticmethod
        def forward(ctx, hyp3, fea_l, fea_r):
            ctx.save_for_backward(hyp3, fea_l, fea_r)
            out = fwd(hyp3, fea_l, fea_r)
            if nudge:
                up = torch.rand(out.shape, generator=coins,
                                device=out.device) < 0.5
                out = torch.nextafter(out, torch.where(
                    up, torch.inf, -torch.inf).to(out.dtype))
            return out

        @staticmethod
        def backward(ctx, g):
            return bwd(g.contiguous(), *ctx.saved_tensors)

    saved = hitnet.tile_warp_cost
    hitnet.tile_warp_cost = lambda h, fl, fr, form="exact": Halves.apply(
        h, fl, fr)
    try:
        yield
    finally:
        hitnet.tile_warp_cost = saved


@contextlib.contextmanager
def backward_inputs():
    """Keep the inputs (g, hyp3, fea_l, fea_r) of every call of kernel 1's
    backward on the model's own path."""
    from codd_torch.ops import tile_warp as tw
    kept, real = [], tw.tile_warp_cost_backward

    def keep(*args):
        kept.append(args)
        return real(*args)

    tw.tile_warp_cost_backward = keep
    try:
        yield kept
    finally:
        tw.tile_warp_cost_backward = real


@contextlib.contextmanager
def decisions():
    """Record the stereo net's hard decisions: each tile-warp call's hyp3
    (its floor()s follow from it) and each ``torch.argmax`` result (the
    TileUpdate selections)."""
    import torch
    from codd_torch.models.stereo import hitnet
    rec = {"hyp3": [], "argmax": []}
    real_argmax, real_warp = torch.argmax, hitnet.tile_warp_cost

    def argmax(*a, **k):
        rec["argmax"].append(real_argmax(*a, **k))
        return rec["argmax"][-1]

    def warp(hyp3, fl, fr, form="exact"):
        rec["hyp3"].append(hyp3.detach())
        return real_warp(hyp3, fl, fr, form)

    torch.argmax, hitnet.tile_warp_cost = argmax, warp
    try:
        yield rec
    finally:
        torch.argmax, hitnet.tile_warp_cost = real_argmax, real_warp


def decisions_apart(a, b):
    """(argmax elements that differ, of all; tap columns floor(x - d) that
    differ, of all) between two records of ``decisions``."""
    import torch
    from codd_torch.ops.upsample import to_plane

    def floors(h):
        d = to_plane(h[..., 0], h[..., 1], h[..., 2], size=4)
        return torch.floor(torch.arange(d.shape[-1], dtype=d.dtype,
                                        device=d.device) - d)

    sel = sum(int((x != y).sum()) for x, y in zip(a["argmax"], b["argmax"]))
    taps = sum(int((floors(x) != floors(y)).sum())
               for x, y in zip(a["hyp3"], b["hyp3"]))
    return (sel, sum(x.numel() for x in a["argmax"]), taps,
            sum(x[..., 0].numel() * 16 for x in a["hyp3"]))


def _cut_outputs(x, path, cut):
    """``x`` (the model's nested outputs) with each tensor t at ``path``
    replaced by ``cut(path, t)``."""
    import torch
    if torch.is_tensor(x):
        return cut(path, x)
    if isinstance(x, dict):
        return {k: _cut_outputs(v, k, cut) for k, v in x.items()}
    if isinstance(x, list):
        return [_cut_outputs(v, path, cut) for v in x]
    return x


def stage_grads(model, loss_cfg, batch, cotangents=None, bf16=False):
    """Loss and every parameter's gradient of one batch, no update, and the
    loss's cotangents at the model's outputs as (output name, tensor).
    With ``cotangents`` (an earlier run's), the backward starts from those
    at the outputs instead of from this run's loss.  The forward is the
    step's own (``trainer.training_forward``), under bf16 compute with
    ``bf16``."""
    import torch
    from codd_torch.losses.assembly import codd_train_loss
    from codd_torch.train.trainer import training_forward
    model.zero_grad(set_to_none=True)
    with training_forward(model, bf16) as forward:
        outs, _ = forward(batch)
        cuts = []

        def cut(path, t):
            if not t.requires_grad:
                return t
            cuts.append((path, t, t.detach().requires_grad_()))
            return cuts[-1][2]

        loss, _ = codd_train_loss(loss_cfg, _cut_outputs(outs, "", cut),
                                  batch)
        cots = torch.autograd.grad(loss, [c for _, _, c in cuts],
                                   allow_unused=True)
        cots = [(p, torch.zeros_like(c) if g is None else g)
                for (p, _, c), g in zip(cuts, cots)]
        torch.autograd.backward([t for _, t, _ in cuts],
                                [g for _, g in cotangents or cots])
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, cots


def grads_apart(a, b, floor: float = 0.0, show: int = 0):
    """Worst per-tensor |a - b| / max(|b|, floor * the largest |b|) over the
    parameters of ``b``; with ``show``, the ``show`` worst tensors with
    their error and norm (as a share of the largest) are printed."""
    top = max(float(g.norm()) for g in b.values()) if b else 0.0
    errs = sorted(((float((a[k] - g).norm() / g.norm().clamp(
        min=max(floor * top, 1e-30))), k, float(g.norm()) / top)
        for k, g in b.items()), reverse=True)
    for e, k, n in errs[:show]:
        print(f"      {k}: {e:.2e} (norm {n:.1e} of the largest)")
    return (errs[0][0], errs[0][1]) if errs else (0.0, None)


def stereo_grad_checks(model, lc, batch):
    """One batch of the stereo stage, gradients only, no update.  Gated:
    kernel 1's backward on each of the step's own calls against its plain
    backward (phase 3's tolerance); the step with only the backward
    swapped for the plain one (kernels' forward kept, bound 1e-5); the step
    with kernel 1's plain forward and backward (bound 1e-3).  Traced, not
    gated: the forward alone swapped; the hard decisions (TileUpdate's
    argmax, the taps' floor(), the loss's masks) that differ between the
    kernel's and the plain forward; the plain run's backward started from
    the kernel run's loss cotangents at the model's outputs; the kernels
    with their forward outputs moved one ulp at random."""
    import torch
    from codd_torch.ops import tile_warp as tw
    with backward_inputs() as kept, decisions() as dk:
        lk, gk, ck = stage_grads(model, lc, batch)
    worst = 0.0
    for i, args in enumerate(kept):
        with torch.no_grad():
            got = tw.tile_warp_cost_backward(*args)
            ref = tw.tile_warp_cost_backward_plain(*args)
        for n, a, b in zip(("dhyp3", "dfea_l", "dfea_r"), got, ref):
            # phase 3's tolerance: the same floor() and sign decisions,
            # sums in another order, dfea_r's atomics
            top = b.abs().max()
            err = (a - b).abs()
            if not torch.isfinite(a).all() or bool(
                    (err > 1e-5 * top + 1e-5 * b.abs()).any()):
                fail(f"tile_warp_cost_backward: {n} of call {i} of a stereo "
                     "step disagrees with its plain backward")
            worst = max(worst, float(err.max() / top.clamp(min=1e-30)))
    shapes = sorted({tuple(x[2].shape) for x in kept})
    print(f"  stereo stage, one batch: kernel 1's backward on the step's "
          f"{len(kept)} calls (fea_l {shapes}) against its plain backward "
          f"on the same inputs: worst |err| / max|ref| {worst:.2e} "
          f"(tolerance 1e-5 of max|ref| + 1e-5 relative)", flush=True)
    del kept

    def against_kernels(label, forward, backward, cotangents=None,
                        nudge=False):
        with tile_warp_halves(forward, backward, nudge), decisions() as d:
            lx, gx, cx = stage_grads(model, lc, batch, cotangents)
        err, where = grads_apart(gk, gx)
        loss_err = abs(lk - lx) / abs(lx)
        print(f"    {label}: loss {lx:.6f} (rel {loss_err:.2e}), worst "
              f"gradient |diff| / |plain| {err:.2e} at {where}", flush=True)
        return loss_err, err, set(gx) == set(gk), d, cx

    print(f"  stereo stage, one batch, {len(gk)} gradient tensors against "
          f"the kernels' own (loss {lk:.6f}):", flush=True)
    noise = against_kernels("kernels again", "kernel", "kernel")[1]
    lb, eb, same_b, _, _ = against_kernels(
        "plain backward (bound 1e-5, loss 1e-6)", "kernel", "plain")
    lp, ep, same_p, dp, cp = against_kernels(
        "plain forward and backward (bound 1e-3, loss 1e-5)", "plain",
        "plain")
    against_kernels("plain forward (traced)", "plain", "kernel")
    against_kernels("plain forward and backward from the kernels' loss "
                    "cotangents at the outputs (traced)", "plain", "plain", ck)
    against_kernels("kernels, each forward output moved one ulp at random "
                    "(traced)", "kernel", "kernel", nudge=True)
    sel, n_sel, taps, n_taps = decisions_apart(dk, dp)
    # a loss mask that flips (|d - gt| against 1, 1.5 or a truncation)
    # moves an element's cotangent by its whole size; smooth changes by
    # ~1e-6 of it
    flips = {}
    for (name, a), (_, b) in zip(ck, cp):
        n = int(((a - b).abs() > 1e-3 * a.abs().max()).sum())
        flips[name] = flips.get(name, 0) + n
    print(f"    hard decisions, kernels' forward against plain forward: "
          f"argmax {sel} of {n_sel} elements in {len(dk['argmax'])} calls; "
          f"taps' floor() {taps} of {n_taps} pixels in {len(dk['hyp3'])} "
          f"calls; loss cotangents moved by > 1e-3 of their tensor's "
          f"largest {flips} of {sum(a.numel() for _, a in ck)}; the kernels "
          f"run twice differ by {noise:.2e}", flush=True)
    if not same_b or eb > 1e-5 or lb > 1e-6:
        fail("stereo stage: the gradients with kernel 1's backward disagree "
             "with those of its plain backward")
    if not same_p or ep > 1e-3 or lp > 1e-5:
        fail("stereo stage: the kernels' gradients disagree with kernel "
             "1's plain forward and backward")


@contextlib.contextmanager
def wrapper_dtypes():
    """The dtypes of the floating tensors that reach each kernel's wrapper
    on the card (``kernels.check_cuda``, which every wrapper calls before
    its launch): yields {kernel: set of dtype tuples}."""
    from codd_torch.ops import kernels
    real, seen = kernels.check_cuda, {}

    def keep(name, *tensors, dtypes=None):
        seen.setdefault(name, set()).add(tuple(
            str(t.dtype).replace("torch.", "") for t in tensors
            if t.is_floating_point()))
        return real(name, *tensors, dtypes=dtypes)

    kernels.check_cuda = keep
    try:
        yield seen
    finally:
        kernels.check_cuda = real


# gradients with the kernels against those with kernel 1's plain bf16
# backward alone, in bf16 compute: a bound on each tensor's |diff| / |norm|,
# stated before the first run (PERF.md, PR 14), with each norm counted as
# at least BF16_NORM_FLOOR of the largest.  The f32 gates' floor is 1e-5;
# in bf16 the gradients that vanish by invariance (fnet's biases in front
# of instance norms) are rounding noise of up to 3.0e-5 of the largest
# norm (1.9e-9 in f32)
BF16_GRAD_BOUND = 2e-2
BF16_NORM_FLOOR = 1e-3


def bf16_grad_checks(label, model, lc, batch, f32_dtypes):
    """One batch of a stage under bf16 compute, gradients only, no update.
    Gated: kernel 1 and its backward take bf16 on every call, every other
    kernel the dtypes it takes in the f32 stage (``f32_dtypes``: kernels 4,
    5 and 6 and their backward keep their f32 forms); 1b on each of the
    step's own calls against its plain bf16 backward (phase 3's bounds);
    each gradient with the kernels against the one with 1b's plain bf16
    backward alone, within ``BF16_GRAD_BOUND`` of its norm, a norm counted
    as at least ``BF16_NORM_FLOOR`` of the largest, both runs with 6b's
    plain backward and deterministic cuDNN and ATen; printed beside the
    run-to-run difference of every kernel's own bf16 gradients."""
    import torch
    from codd_torch.ops import tile_warp as tw
    with backward_inputs() as kept, wrapper_dtypes() as seen:
        lk, gk, _ = stage_grads(model, lc, batch, bf16=True)
    print(f"  {label}, one batch: the dtypes reaching each kernel's wrapper: "
          f"{ {k: sorted(v) for k, v in sorted(seen.items())} }", flush=True)
    for name, sigs in seen.items():
        if name.startswith("tile_warp"):
            if any(set(sig) != {"bfloat16"} for sig in sigs):
                fail(f"{label}: {name} took {sorted(sigs)}, not bf16")
        elif sigs != f32_dtypes.get(name):
            fail(f"{label}: {name} took {sorted(sigs)}; in the f32 stage "
                 f"{sorted(f32_dtypes.get(name, ()))}")
    if len(kept) != 18:
        fail(f"{label}: kernel 1's backward ran {len(kept)} times, not 18")
    worst = 0.0
    for i, args in enumerate(kept):
        with torch.no_grad():
            _, off = tile_warp_backward_bf16_compare(f"{label} call {i}",
                                                     args, quiet=True)
        worst = max(worst, off)
    # the gate's two runs: 6b's atomics across blocks are the one
    # run-to-run order left once cuDNN and ATen are deterministic, and in
    # bf16 they move fnet's gradients by ~5e-2 of their norm (call 14), so
    # both runs take 6b's plain backward
    from codd_torch.ops import corr
    with motion_backwards(None, corr.corr_patch_lookup_backward_plain), \
            deterministic():
        lg, gg, _ = stage_grads(model, lc, batch, bf16=True)
        with tile_warp_halves("kernel", "plain"):
            lp, gp, _ = stage_grads(model, lc, batch, bf16=True)
    lk2, gk2, _ = stage_grads(model, lc, batch, bf16=True)
    err, where = grads_apart(gg, gp, BF16_NORM_FLOOR, show=3)
    noise, _ = grads_apart(gk2, gk, BF16_NORM_FLOOR)
    top = max(float(g.norm()) for g in gp.values())
    below = sum(float(g.norm()) < BF16_NORM_FLOOR * top for g in gp.values())
    print(f"  {label}, one batch, 6b plain and cuDNN and ATen deterministic "
          f"(loss {lg:.6f}; with 1b's plain bf16 backward {lp:.6f}): worst "
          f"gradient |diff| / |norm| against 1b's plain bf16 backward "
          f"{err:.2e} at {where} (bound {BF16_GRAD_BOUND:g}; {len(gp)} "
          f"tensors, {below} with a norm below the floor of "
          f"{BF16_NORM_FLOOR:g} of the largest); every kernel, run twice "
          f"(loss {lk:.6f}, {lk2:.6f}): apart by up to {noise:.2e} (traced); "
          f"dfea_r off the plain bits on at most {worst:.2e} of a call's "
          f"elements", flush=True)
    if set(gp) != set(gk) or set(gg) != set(gk) or err > BF16_GRAD_BOUND:
        fail(f"{label}: the gradients with kernel 1's bf16 backward "
             f"disagree with those of its plain bf16 backward: {err:.2e} "
             f"at {where}")


def motion_step_launches():
    """The motion stage's launches a step: frozen stereo 9 tile warps a
    frame; 16 GN iterations, each checkpointed, so kernels 5 and 6 run
    their forward twice and their backward once; both splats of each of
    the 4 images, forward only."""
    from codd_torch.ops import kernels
    return dict(dict.fromkeys(kernels.KERNELS, 0), tile_warp_cost=18,
                corr_patch_lookup=32, gn_window_aggregate=32,
                corr_patch_lookup_backward=16,
                gn_window_aggregate_backward=16, splat_composite=2 * TRAIN_B)


def full_joint_step_launches():
    """The full joint stage's launches a step (configs/models/codd.py,
    nothing frozen): the motion stage's, kernel 4's backward after each
    splat, the stereo stage's kernel 1 backward (9 a frame) and the
    coordinate gradient once a GN iteration."""
    return dict(motion_step_launches(), splat_composite_backward=2 * TRAIN_B,
                tile_warp_cost_backward=18,
                corr_patch_lookup_coords_backward=16)


def train_stage(label, model, opt, loss_cfg, batches, frozen=(),
                profile_to=None, bf16=False):
    """``len(batches)`` training steps, each timed by CUDA events; the
    counts are set to 0 just before and read just after.  Fails on a
    non-finite loss or a frozen parameter that moved; with ``bf16``
    (``make_train_step(bf16_compute=True)``), also on a master parameter
    or an Adam moment that is not f32.  With ``profile_to``, one more step
    under torch.profiler afterwards."""
    import torch
    from codd_torch.ops import kernels
    from codd_torch.train import trainer
    params = dict(model.named_parameters())
    kept = {k: p.detach().clone() for k, p in params.items()
            if k.split(".")[0] in frozen}
    step = trainer.make_train_step(model, opt, loss_cfg, bf16_compute=bf16)
    state = trainer.create_train_state(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    kernels.reset_counts()
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        loss = float(logs["loss"])
        print(f"  {label} step {i}: loss {loss:.6f}  grad_norm "
              f"{float(logs['grad_norm']):.6f}  skipped "
              f"{int(logs['step_skipped'])}  {ms[-1]:.1f} ms", flush=True)
        if not np.isfinite(loss):
            fail(f"{label}: non-finite loss at step {i}")
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    b, t, h, w = batches[0]["l_img"].shape[:4]
    moved = [k for k, v in kept.items() if not torch.equal(params[k], v)]
    if moved:
        fail(f"{label}: frozen parameters moved: {moved[:5]}")
    not32 = [k for tree in (state.params, state.opt_state.mu,
                            state.opt_state.nu)
             for k, v in tree.items() if v.dtype != torch.float32]
    if not32:
        fail(f"{label}: masters or Adam moments not f32: {not32[:5]}")
    print(f"  {label}: {len(batches)} steps at B={b}, T={t}, {h}x{w}: ms a "
          f"step {['%.1f' % x for x in ms]}, "
          f"median of steps 1-{len(ms) - 1} "
          f"{float(np.median(ms[1:] or ms)):.1f} ms; peak {peak:.2f} GiB; "
          f"{len(kept)} frozen tensors kept their bits; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if profile_to is not None:
        profile_call(lambda: step(state, batches[0]),
                     f"one {label} step at B={b}, T={t}, {h}x{w}",
                     profile_to)
    return launches


def train_phase(dev, profile_dir=None):
    """The stereo stage, the fusion stage, the motion stage, the joint
    stage, then the full joint stage; returns the launches of the five
    runs, summed by kernel.  With ``profile_dir``, one more step of each
    under torch.profiler (profile_train_{stereo,fusion,motion,
    volume_motion,joint,joint_full}.txt) and the run-to-run traces."""
    prof = (lambda n: None) if profile_dir is None else \
        (lambda n: profile_dir / f"profile_train_{n}.txt")
    import torch
    from codd_torch.models.builder import build_estimator, build_loss_config
    from codd_torch.ops import kernels
    from codd_torch.train import optim

    batches = train_batches(TRAIN_STEPS, dev)
    cfg = model_cfg("stereo.py")
    model, lc = build_model("stereo.py"), build_loss_config(cfg)
    with wrapper_dtypes() as stereo_dtypes:
        stereo_grad_checks(model, lc, batches[0])
    opt = optim.make_optimizer(optim.multi_gamma_schedule(
        4e-4, [225, 293, 315], [0.25, 0.4, 0.25]), 1.0)
    stereo = train_stage("stereo stage", model, opt, lc, batches,
                         profile_to=prof("stereo"))
    if stereo["tile_warp_cost_backward"] == 0:
        fail("stereo stage: kernel 1's backward never launched")
    del model, opt
    torch.cuda.empty_cache()

    # the stereo stage with tile_warp_variant="tilewin": codd_tpu's
    # windowed warp as ATen ops, differentiated by autograd; kernel 1 never
    # launches; one step
    tcfg = dict(cfg, runtime=dict(cfg.get("runtime") or {},
                                  tile_warp_variant="tilewin"))
    model = build_estimator(tcfg, device="cuda", seed=0)
    opt = optim.make_optimizer(optim.multi_gamma_schedule(
        4e-4, [225, 293, 315], [0.25, 0.4, 0.25]), 1.0)
    tilewin = train_stage("tilewin stereo stage", model, opt, lc,
                          batches[:1])
    if any(tilewin.values()):
        fail(f"tilewin stereo stage: hand kernels launched: {tilewin}")
    del model, opt
    torch.cuda.empty_cache()

    freeze = {"freeze_stereo": True, "freeze_motion": True}
    cfg = model_cfg("codd.py", train_cfg=freeze)
    model, lc = build_model("codd.py", train_cfg=freeze), \
        build_loss_config(cfg)
    opt = optim.make_optimizer(optim.one_cycle_schedule(2e-4, 100000 // 8),
                               1.0, dict(model.named_parameters()),
                               ["stereo", "motion"])
    fusion = train_stage("fusion stage", model, opt, lc, batches,
                         ("stereo", "motion"), prof("fusion"))
    if fusion["tile_warp_cost_backward"]:
        fail("fusion stage: a backward kernel launched with stereo frozen")
    missing = [k for k in ("tile_warp_cost", "corr_lookup", "gn_fused_solve",
                           "splat_composite") if not fusion[k]]
    if missing:
        fail(f"fusion stage: kernels {missing} never launched")
    del model, opt
    torch.cuda.empty_cache()

    mb = motion_batches(TRAIN_STEPS, dev)
    cfg = model_cfg("stereo_motion.py")
    model, lc = build_model("stereo_motion.py"), build_loss_config(cfg)
    motion_grad_checks(model, lc, mb[0], trace=profile_dir is not None)
    opt = optim.make_optimizer(optim.one_cycle_schedule(2e-4, 200000 // 8),
                               1.0, dict(model.named_parameters()),
                               ["stereo"])
    motion = train_stage("motion stage", model, opt, lc, mb, ("stereo",),
                         prof("motion"))
    per_step = motion_step_launches()
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if motion != want:
        fail(f"motion stage: launches {motion} != {want}")
    del model, opt
    torch.cuda.empty_cache()

    # the motion stage through the volumes (corr_impl="volume"): kernel 2
    # forward, twice an iteration, and kernel 2b in the backward; one step
    vcfg = dict(cfg, runtime=dict(cfg.get("runtime") or {},
                                  corr_impl="volume"))
    model = build_estimator(vcfg, device="cuda", seed=0)
    volume_motion_checks(model, lc, mb[0])
    opt = optim.make_optimizer(optim.one_cycle_schedule(2e-4, 200000 // 8),
                               1.0, dict(model.named_parameters()),
                               ["stereo"])
    volume = train_stage("volume motion stage", model, opt, lc, mb[:1],
                         ("stereo",), prof("volume_motion"))
    want = dict(per_step, corr_patch_lookup=0, corr_patch_lookup_backward=0,
                corr_lookup=32, corr_lookup_backward=16)
    if volume != want:
        fail(f"volume motion stage: launches {volume} != {want}")
    del model, opt
    torch.cuda.empty_cache()

    # the motion stage with gn_bf16_scores at 384x1024 crops (48x128 at
    # 1/8, where codd_tpu scores in bf16): kernel 5's forward in its bf16
    # form and its backward in the bf16-score form; one step
    bb = motion_batches(1, dev, w=1024)
    bcfg = dict(cfg, runtime=dict(cfg.get("runtime") or {},
                                  gn_bf16_scores=True))
    model = build_estimator(bcfg, device="cuda", seed=0)
    bf16_scores_motion_checks(model, lc, bb[0])
    opt = optim.make_optimizer(optim.one_cycle_schedule(2e-4, 200000 // 8),
                               1.0, dict(model.named_parameters()),
                               ["stereo"])
    scores16 = train_stage("bf16-score motion stage", model, opt, lc, bb,
                           ("stereo",))
    want = dict(per_step, gn_window_aggregate_backward=0,
                gn_window_aggregate_backward_bf16=16)
    if scores16 != want:
        fail(f"bf16-score motion stage: launches {scores16} != {want}")
    del model, opt, bb
    torch.cuda.empty_cache()

    # the joint stage, stereo frozen: the motion stage's launches, and
    # kernel 4's backward after each splat (the fusion net reads the
    # warped memory; its convolutions launch no hand kernel)
    freeze = {"freeze_stereo": True}
    cfg = model_cfg("codd.py", train_cfg=freeze)
    model, lc = build_model("codd.py", train_cfg=freeze), \
        build_loss_config(cfg)
    joint_grad_checks("joint stage", model, lc, mb[0],
                      trace=profile_dir is not None)
    opt = optim.make_optimizer(optim.one_cycle_schedule(2e-4, 100000 // 8),
                               1.0, dict(model.named_parameters()),
                               ["stereo"])
    joint = train_stage("joint stage", model, opt, lc, mb, ("stereo",),
                        prof("joint"))
    joint_step = dict(per_step, splat_composite_backward=2 * TRAIN_B)
    want = {k: v * TRAIN_STEPS for k, v in joint_step.items()}
    if joint != want:
        fail(f"joint stage: launches {joint} != {want}")
    del model, opt
    torch.cuda.empty_cache()

    # the whole model trained (configs/models/codd.py as it stands, with
    # schedule_stereo's optimizer, as configs/training_config.py composes
    # them)
    cfg = model_cfg("codd.py")
    model, lc = build_model("codd.py"), build_loss_config(cfg)
    with wrapper_dtypes() as full_dtypes:
        joint_grad_checks("full joint stage", model, lc, mb[0],
                          stereo_frozen=False)
    opt = optim.make_optimizer(optim.multi_gamma_schedule(
        4e-4, [225, 293, 315], [0.25, 0.4, 0.25]), 1.0)
    full = train_stage("full joint stage", model, opt, lc, mb,
                       profile_to=prof("joint_full"))
    want = {k: v * TRAIN_STEPS for k, v in full_joint_step_launches().items()}
    if full != want:
        fail(f"full joint stage: launches {full} != {want}")
    del model, opt
    torch.cuda.empty_cache()

    # bf16 compute (runtime.bf16_compute, codd_tpu's mixed precision: f32
    # masters, bf16 copies in the step): the stereo stage, then the full
    # joint stage, each with the launches of its f32 stage
    cfg = model_cfg("stereo.py")
    model, lc = build_model("stereo.py"), build_loss_config(cfg)
    bf16_grad_checks("stereo bf16 stage", model, lc, batches[0],
                     stereo_dtypes)
    opt = optim.make_optimizer(optim.multi_gamma_schedule(
        4e-4, [225, 293, 315], [0.25, 0.4, 0.25]), 1.0)
    stereo16 = train_stage("stereo bf16 stage", model, opt, lc, batches,
                           profile_to=prof("stereo_bf16"), bf16=True)
    if stereo16 != stereo:
        fail(f"stereo bf16 stage: launches {stereo16} != the f32 stage's "
             f"{stereo}")
    del model, opt
    torch.cuda.empty_cache()
    cfg = model_cfg("codd.py")
    model, lc = build_model("codd.py"), build_loss_config(cfg)
    bf16_grad_checks("full joint bf16 stage", model, lc, mb[0], full_dtypes)
    opt = optim.make_optimizer(optim.multi_gamma_schedule(
        4e-4, [225, 293, 315], [0.25, 0.4, 0.25]), 1.0)
    full16 = train_stage("full joint bf16 stage", model, opt, lc, mb,
                         profile_to=prof("joint_full_bf16"), bf16=True)
    if full16 != want:
        fail(f"full joint bf16 stage: launches {full16} != {want}")
    del model, opt
    torch.cuda.empty_cache()
    return {k: stereo[k] + fusion[k] + motion[k] + volume[k] + scores16[k]
            + joint[k] + full[k] + stereo16[k] + full16[k] for k in stereo}


# ---------------------------------------------------------------------------
# entry: python -m codd_torch.tools.train's path, through the data pipeline
# ---------------------------------------------------------------------------

ENTRY_SEQS, ENTRY_FRAMES, ENTRY_H, ENTRY_W = 3, 4, 540, 960
ENTRY_STEPS = 4
ENTRY_DIR = Path(__file__).resolve().parent / "build" / "entry_smoke"
TRAINING_CONFIG = Path(__file__).resolve().parent / "configs" / \
    "training_config.py"


def write_entry_dataset(root: Path) -> Path:
    """SceneFlow-shaped synthetic data under ``root``: ``ENTRY_SEQS``
    sequences of ``ENTRY_FRAMES`` 540x960 frames of ``frames()``' panning
    plane (8-bit PNGs whose rows cycle through the five filter types,
    encoded with zlib by ``io.write_png``), PFM disparity 8 + t, flow
    (-2, 0) and disparity change 1, and a split file; returns the split's
    path."""
    import torch
    from codd_torch.data.io import write_pfm, write_png
    lines = []
    shape = (ENTRY_H, ENTRY_W)
    flow = np.zeros(shape + (3,), np.float32)
    flow[..., 0] = -2.0
    for s in range(ENTRY_SEQS):
        seq = frames(ENTRY_FRAMES, "cpu", seed=21 + s, h=ENTRY_H, w=ENTRY_W)
        for t, pair in enumerate(seq):
            name = f"{s:02d}/{t:04d}"
            cols = []
            for side, img in zip(("left", "right"), pair):
                (root / side / f"{s:02d}").mkdir(parents=True, exist_ok=True)
                u8 = (img[0].clamp(0, 1.1) / 1.1 * 255).round().to(
                    torch.uint8).numpy()
                write_png(str(root / side / f"{name}.png"), u8)
                cols.append(f"{side}/{name}.png")
            for kind, arr in (("disp", np.full(shape, 8.0 + t, np.float32)),
                              ("flow", flow),
                              ("disp_change", np.ones(shape, np.float32))):
                (root / kind / f"{s:02d}").mkdir(parents=True, exist_ok=True)
                write_pfm(str(root / kind / f"{name}.pfm"), arr)
                cols.append(f"{kind}/{name}.pfm")
            lines.append(" ".join(cols))
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    return split


def decoder_check(root: Path):
    """Every PNG of the phase through the native decoder and through
    ``read_png``: equal in every byte; ms a frame of each (and of
    ``imread``)."""
    from codd_torch.data import io as dio
    from codd_torch.data import native
    paths = sorted(root.rglob("*.png"))
    native.load_library()
    t_native = t_plain = t_imread = 0.0
    for p in paths:
        t0 = time.perf_counter()
        a = native.decode(str(p))
        t1 = time.perf_counter()
        b = dio.read_png(str(p))
        t2 = time.perf_counter()
        c = dio.imread(str(p))
        t3 = time.perf_counter()
        t_native, t_plain, t_imread = (t_native + t1 - t0, t_plain + t2 - t1,
                                       t_imread + t3 - t2)
        if a.dtype != b.dtype or a.shape != b.shape \
                or not np.array_equal(a, b) or not np.array_equal(a, c):
            fail(f"entry: the native decode of {p} differs from read_png")
    n = len(paths)
    print(f"  decoder: {n} PNGs of {ENTRY_H}x{ENTRY_W}x3 (rows cycling "
          f"through filters 0-4) equal in bits to read_png; ms a frame: "
          f"native decode {1e3 * t_native / n:.2f}, imread "
          f"{1e3 * t_imread / n:.2f}, read_png {1e3 * t_plain / n:.1f}",
          flush=True)
    return 1e3 * t_native / n, 1e3 * t_plain / n


def entry_config(root: Path, split: Path):
    """configs/training_config.py with only the data paths, the checkpoint
    and evaluation intervals and the log interval overridden; fails if the
    composition is not the full joint recipe at SceneFlow's shape.
    Returns the config and the data paths' ``--options``."""
    from codd_torch.config import load_config
    paths = [f"data.{part}.{k}={v}" for part in ("train", "val")
             for k, v in (("data_root", root), ("split", split))]
    cfg = load_config(str(TRAINING_CONFIG), paths + [
        "checkpoint.interval=2", f"evaluation.interval={ENTRY_STEPS}",
        "runtime.log_interval=1"])
    m, d, sch = cfg["model"], cfg["data"]["train"], cfg["schedule"]
    want = {"motion": "Motion", "fusion": "Fusion",
            "frozen": [], "crop_size": (TRAIN_H, TRAIN_W), "photometric": True,
            "asym": True, "batch_size": TRAIN_B, "num_frames": TRAIN_T,
            "schedule": ("multi_gamma", 4e-4, 1.0)}
    got = {"motion": m["motion"]["type"], "fusion": m["fusion"]["type"],
           "frozen": [k for k, v in (m.get("train_cfg") or {}).items() if v],
           "crop_size": tuple(d["augment"]["crop_size"]),
           "photometric": d["augment"]["photometric"],
           "asym": d["augment"]["asym"], "batch_size": d["batch_size"],
           "num_frames": d["num_frames"],
           "schedule": (sch["kind"], sch["base_lr"], sch["grad_clip"])}
    if got != want:
        fail(f"entry: configs/training_config.py composed to {got}, "
             f"not {want}")
    return cfg, paths


def validation_launches(n_seqs: int, T: int):
    """The default configuration's launches over ``n_seqs`` sequences of
    ``T`` frames (phase 4's per frame: kernel 1 9 a frame; kernels 2 and
    3 16, kernel 4 twice, from the second frame on)."""
    from codd_torch.ops import kernels
    return dict(dict.fromkeys(kernels.KERNELS, 0),
                tile_warp_cost=9 * T * n_seqs,
                corr_lookup=16 * (T - 1) * n_seqs,
                gn_fused_solve=16 * (T - 1) * n_seqs,
                splat_composite=2 * (T - 1) * n_seqs)


def _load_paced(train_dcfg, n, ready, go, drawn):
    """In a process of its own: draw the entry's training batches, one
    each time ``go`` is released, ``n`` in all, and drop them; ``drawn``
    counts them."""
    from codd_torch.apis.train import build_dataset_from_cfg
    from codd_torch.data.loader import batch_iterator
    it = batch_iterator(build_dataset_from_cfg(train_dcfg, train=True),
                        TRAIN_B)
    next(it)
    ready.set()
    for _ in range(n):
        go.acquire()
        next(it)
        with drawn.get_lock():
            drawn.value += 1


def inmemory_steps(label, step, state, batches, beside=None):
    """The train phase's full joint step on in-memory batches, timed on
    the host clock up to a synchronize (the entry's ms, without data).
    ``beside()``, where given, runs before each step: it starts the
    entry's host work on one batch elsewhere (a thread or a process),
    which the step does not use."""
    import torch
    ms = []
    for b in batches:
        t0 = time.perf_counter()
        if beside is not None:
            beside()
        state, logs = step(state, b)
        loss = float(logs["loss"])
        ms.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(loss):
            fail(f"{label}: non-finite loss")
    torch.cuda.synchronize()
    print(f"  {label}: full joint step on in-memory batches, host ms "
          f"{['%.1f' % t for t in ms]}", flush=True)
    return state, ms


def entry_run(label, cfg, work: Path, dev, **kw):
    """``train_estimator`` on the card as a user runs it; per step the
    loss, grad_norm, host ms (data included) and data wait of its own
    ``metrics.jsonl`` rows, and the launches since the row before, and the
    validation rows with theirs.  Returns (state, step, step rows,
    validation rows, log lines, crc32 of the left images of each batch
    drawn, the init batch first: taken in the prefetch thread)."""
    import zlib

    from codd_torch.apis import train as tapi
    from codd_torch.ops import kernels

    steps, vals, lines, crcs = [], [], [], []

    class Rows(tapi.MetricLogger):
        """Each row of metrics.jsonl with the launches since the last."""

        def log(self, step, row):
            super().log(step, row)
            launches = kernels.counts()
            kernels.reset_counts()
            (vals if "val/ms" in row else steps).append((step, row,
                                                         launches))

    real_iter, real_log = tapi.batch_iterator, tapi.MetricLogger

    def batch_iterator(*args, **kwargs):
        for batch in real_iter(*args, **kwargs):
            crcs.append(zlib.crc32(np.ascontiguousarray(batch["l_img"]).data))
            yield batch

    tapi.batch_iterator, tapi.MetricLogger = batch_iterator, Rows
    try:
        kernels.reset_counts()
        state, step = tapi.train_estimator(cfg, str(work), device=dev,
                                           log=lines.append, **kw)
    finally:
        tapi.batch_iterator, tapi.MetricLogger = real_iter, real_log
    want = full_joint_step_launches()
    for s, row, launches in steps:
        print(f"  {label} step {s}: loss {row['loss']:.6f}  grad_norm "
              f"{row['grad_norm']:.6f}  {row['step_ms']:.1f} ms (host, data "
              f"included; data wait {row['data_wait_ms']:.1f})  launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        if not np.isfinite(row["loss"]):
            fail(f"{label}: non-finite loss at step {s}")
        if launches != want:
            fail(f"{label}: step {s} launches {launches} != the full joint "
                 f"stage's {want}")
    return state, step, steps, vals, lines, crcs


def loader_beside(cfg, step, mstate, mb):
    """The in-memory full joint step with the entry's data work beside it,
    a batch a step drawn and dropped: in the entry's ``Prefetcher`` thread
    (which shares the GIL with the launch loop), then in a process of its
    own (which shares only the host's cores and memory).  Fails unless
    the process drew a batch a step and exited 0.  Returns the state and
    the host ms a step of each."""
    import multiprocessing

    from codd_torch.apis.train import build_dataset_from_cfg
    from codd_torch.data.loader import Prefetcher, batch_iterator
    batches = mb + mb[:1]
    loader = Prefetcher(batch_iterator(build_dataset_from_cfg(
        cfg["data"]["train"], train=True), TRAIN_B))
    next(loader)  # the first batch's wait is not a step's
    next(loader)
    mstate, thread_ms = inmemory_steps(
        "in-memory beside the entry's prefetch thread", step, mstate,
        batches, beside=lambda: next(loader))
    loader.close()
    ctx = multiprocessing.get_context("spawn")
    ready, go, drawn = ctx.Event(), ctx.Semaphore(0), ctx.Value("i", 0)
    proc = ctx.Process(target=_load_paced, daemon=True,
                       args=(cfg["data"]["train"], len(batches), ready, go,
                             drawn))
    proc.start()
    try:
        t0 = time.perf_counter()
        while not ready.wait(timeout=1):
            if not proc.is_alive() or time.perf_counter() - t0 > 300:
                fail(f"loader: the loading process did not start (exit "
                     f"{proc.exitcode})")
        mstate, process_ms = inmemory_steps(
            "in-memory beside a loading process", step, mstate, batches,
            beside=go.release)
        proc.join(timeout=120)
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    if proc.exitcode != 0 or drawn.value != len(batches):
        fail(f"loader: the loading process exited {proc.exitcode} having "
             f"drawn {drawn.value} of {len(batches)} batches")
    return mstate, thread_ms, process_ms


def entry_phase(dev, loader=False):
    """The training entry on the card (module docstring, phase entry; with
    ``loader``, phase loader too).  Returns the launches of runs (a) and
    (b), summed by kernel."""
    import shutil

    import torch
    from codd_torch.models.builder import build_loss_config
    from codd_torch.train import optim, trainer
    from codd_torch.train.checkpoint import STATE_FILE

    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    root = ENTRY_DIR / "data"
    t0 = time.perf_counter()
    split = write_entry_dataset(root)
    print(f"  dataset: {ENTRY_SEQS} sequences x {ENTRY_FRAMES} frames at "
          f"{ENTRY_H}x{ENTRY_W} written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    decoder_check(root)
    cfg, paths = entry_config(root, split)

    # the in-memory full joint step, in turns with the entry's runs
    model = build_model("codd.py")
    opt = optim.make_optimizer(optim.multi_gamma_schedule(
        4e-4, [225, 293, 315], [0.25, 0.4, 0.25]), 1.0)
    step = trainer.make_train_step(model, opt,
                                   build_loss_config(model_cfg("codd.py")))
    mstate = trainer.create_train_state(model, opt)
    mb = motion_batches(2, dev)
    mstate, mem_ms = inmemory_steps("in-memory (before a)", step, mstate, mb)

    # (a) 4 steps from scratch, checkpoints at 2 and 4, validation at 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, reached, rows_a, vals, lines_a, crc_a = entry_run(
        "entry (a)", cfg, ENTRY_DIR / "a", dev, max_steps=ENTRY_STEPS)
    wall_a = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if reached != ENTRY_STEPS or [s for s, _, _ in rows_a] != list(
            range(1, ENTRY_STEPS + 1)):
        fail(f"entry (a): reached step {reached}, rows "
             f"{[s for s, _, _ in rows_a]}")
    if len(vals) != 1 or vals[0][0] != ENTRY_STEPS:
        fail(f"entry (a): validation rows {[(s, r) for s, r, _ in vals]} "
             f"(one at step {ENTRY_STEPS} expected; log {lines_a[-5:]})")
    _, vrow, vlaunches = vals[0]
    vwant = validation_launches(ENTRY_SEQS, ENTRY_FRAMES)
    print(f"  entry (a): validation at step {ENTRY_STEPS} over "
          f"{ENTRY_SEQS} sequences x {ENTRY_FRAMES} frames padded to 576x960: "
          f"{vrow['val/ms']:.1f} ms; launches "
          f"{ {k: v for k, v in vlaunches.items() if v} }", flush=True)
    print("  " + "\n  ".join(l for line in lines_a if "Summary" in str(line)
                             or "|" in str(line) for l in
                             str(line).strip().splitlines()))
    if vlaunches != vwant:
        fail(f"entry (a): validation launches {vlaunches} != {vwant}")
    bad = [k for k, v in vrow.items() if not np.isfinite(v)]
    if bad or vrow.get("val/count", 0) <= 0:
        fail(f"entry (a): validation metrics {bad} non-finite or no "
             f"scene-flow pixels: {vrow}")
    # the last checkpoint reloads to the state in bits
    blob = torch.load(ENTRY_DIR / "a" / f"ckpt_{ENTRY_STEPS}" / STATE_FILE,
                      map_location="cpu", weights_only=True)
    unequal = [k for k, p in state.params.items()
               if not torch.equal(blob["params"][k], p.detach().cpu())]
    for part in ("mu", "nu"):
        tree = getattr(state.opt_state, part)
        if sorted(tree) != sorted(blob["opt_state"][part]):
            fail(f"entry (a): checkpoint {part} keys differ")
        unequal += [f"{part}.{k}" for k, v in tree.items()
                    if not torch.equal(blob["opt_state"][part][k], v.cpu())]
    if unequal or blob["opt_state"]["count"] != ENTRY_STEPS \
            or blob["step"] != ENTRY_STEPS:
        fail(f"entry (a): ckpt_{ENTRY_STEPS} differs from the saved state: "
             f"{unequal[:5]}, count {blob['opt_state']['count']}")
    if len(state.opt_state.mu) != len(state.params):
        fail("entry (a): a parameter is frozen (none should be)")
    print(f"  entry (a): {len(state.params)} params, mu and nu and count "
          f"{ENTRY_STEPS} reload from ckpt_{ENTRY_STEPS} equal in bits; "
          f"peak {peak:.2f} GiB; {wall_a:.1f} s for the run", flush=True)
    del state, blob
    torch.cuda.empty_cache()

    mstate, ms = inmemory_steps("in-memory (between a and b)", step, mstate,
                                mb)
    mem_ms += ms

    # (b) a fresh run resumed from ckpt_2 to step 4
    state, reached, rows_b, _, lines_b, crc_b = entry_run(
        "entry (b)", cfg, ENTRY_DIR / "b", dev,
        resume_from=str(ENTRY_DIR / "a" / "ckpt_2"), max_steps=ENTRY_STEPS)
    if not any("at step 2" in str(line) for line in lines_b) \
            or [s for s, _, _ in rows_b] != [3, 4] \
            or state.opt_state.count != ENTRY_STEPS:
        fail(f"entry (b): the resumed run did not start at step 2 with "
             f"Adam's count 2: rows {[s for s, _, _ in rows_b]}, log "
             f"{lines_b[:2]}")
    if crc_b[:2] != crc_a[3:5]:
        fail(f"entry (b): resumed batches {crc_b[:2]} != run (a)'s steps "
             f"3-4 {crc_a[3:5]}")
    apart = [rb["loss"] - ra["loss"]
             for (_, rb, _), (_, ra, _) in zip(rows_b, rows_a[2:])]
    print("  entry (b): resumed at step 2 (Adam's count 2) on run (a)'s "
          f"batches of steps 3-4; loss (b) - (a): {apart}", flush=True)
    del state
    torch.cuda.empty_cache()

    mstate, ms = inmemory_steps("in-memory (after b)", step, mstate, mb)
    mem_ms += ms
    if loader:
        mstate, thread_ms, process_ms = loader_beside(cfg, step, mstate, mb)
    mstate, ms = inmemory_steps("in-memory (last)", step, mstate, mb)
    mem_ms += ms
    del mstate, model, step, mb
    torch.cuda.empty_cache()

    # (d) runtime.bf16_compute: 2 steps, a checkpoint at 2, no validation
    from codd_torch.config import load_config
    bcfg = load_config(str(TRAINING_CONFIG), paths + [
        "checkpoint.interval=2", "evaluation.interval=0",
        "runtime.log_interval=1", "runtime.bf16_compute=True"])
    state, reached, rows_d, _, lines_d, _ = entry_run(
        "entry (d) bf16", bcfg, ENTRY_DIR / "d", dev, max_steps=2)
    if "bf16 compute enabled (f32 master params)" not in lines_d \
            or reached != 2 or [s for s, _, _ in rows_d] != [1, 2]:
        fail(f"entry (d): bf16 line, step {reached} or rows "
             f"{[s for s, _, _ in rows_d]} missing; log {lines_d[:3]}")
    blob = torch.load(ENTRY_DIR / "d" / "ckpt_2" / STATE_FILE,
                      map_location="cpu", weights_only=True)
    trees = [(state.params, blob["params"])] + [
        (getattr(state.opt_state, part), blob["opt_state"][part])
        for part in ("mu", "nu")]
    bad = [k for mine, saved in trees for k, v in mine.items()
           if v.dtype != torch.float32 or saved[k].dtype != torch.float32
           or not torch.equal(saved[k], v.detach().cpu())]
    bad += [k for k, v in blob["params"].items()
            if v.is_floating_point() and v.dtype != torch.float32]
    if bad:
        fail(f"entry (d): ckpt_2 does not hold the f32 masters and moments "
             f"in bits: {bad[:5]}")
    print(f"  entry (d): bf16 compute logged, rows 1-2 written, ckpt_2 "
          f"holds the {len(state.params)} f32 masters and f32 moments, equal "
          "in bits", flush=True)
    del state, blob
    torch.cuda.empty_cache()

    # (c) the CLI, one step, in a subprocess
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "codd_torch.tools.train", str(TRAINING_CONFIG),
         "--work-dir", str(ENTRY_DIR / "cli"), "--max-steps", "1",
         "--options", *paths, "evaluation.interval=0"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    out = [line for line in proc.stdout.splitlines() if "step 1/1" in line]
    print(f"  entry (c): python -m codd_torch.tools.train --max-steps 1: exit "
          f"{proc.returncode} in {cli_s:.1f} s; {out}", flush=True)
    if proc.returncode != 0 or not out or "loss=nan" in out[0]:
        fail(f"entry (c): the CLI failed (exit {proc.returncode}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")

    # each run's first step waits for its first batch
    entry_ms = [r["step_ms"] for _, r, _ in rows_a[1:] + rows_b[1:]]
    wait_ms = [r["data_wait_ms"] for _, r, _ in rows_a + rows_b]
    beside = (f", {float(np.median(thread_ms)):.1f} beside the prefetch "
              f"thread, {float(np.median(process_ms)):.1f} beside a loading "
              f"process" if loader else "")
    print(f"  entry: median host ms a step {float(np.median(entry_ms)):.1f} "
          f"(steps 2-4 of a, 4 of b, data included) against "
          f"{float(np.median(mem_ms[1:])):.1f} in memory{beside}; data wait "
          f"ms {['%.1f' % w for w in wait_ms]}; peak {peak:.2f} GiB; "
          f"validation {vrow['val/ms']:.1f} ms; {smi_name_power()}",
          flush=True)
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    return {k: sum(l[k] for _, _, l in rows_a + vals + rows_b + rows_d)
            for k in rows_a[0][2]}


# ---------------------------------------------------------------------------
# dist: multi-process training on the one card
# ---------------------------------------------------------------------------

DIST_DIR = Path(__file__).resolve().parent / "build" / "dist_smoke"
DIST_TIMEOUT = 600  # seconds a group of processes may take

# the training CLI with deterministic cuDNN and ATen algorithms, so that
# two runs can be compared in bits (torchrun runs a script or a module)
_DET_TRAIN = """
import runpy, sys
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
sys.argv[0] = "codd_torch.tools.train"
runpy.run_module("codd_torch.tools.train", run_name="__main__",
                 alter_sys=True)
"""

# one rank of the two-rank stereo step: gloo on the one card (NCCL refuses
# two ranks on one GPU), LOCAL_RANK 0 for both, this rank's half of the
# train phase's first batch, make_train_step under SGD
_GLOO_RANK = """
import datetime, sys
import torch
import chip_smoke as cs
from codd_torch.models.builder import build_loss_config
from codd_torch.parallel import mesh

dev = mesh.init_distributed("cuda", backend="gloo",
                            timeout=datetime.timedelta(seconds=300))
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
rank, world = mesh.process_index(), mesh.process_count()
batch = cs.train_batches(1, dev)[0]
n = batch["l_img"].shape[0] // world
mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
model = cs.build_model("stereo.py")
mesh.broadcast_state(model)
with cs.deterministic():
    before, state, logs = cs.sgd_step(model, build_loss_config(
        cs.model_cfg("stereo.py")), mine)
if rank == 0:
    torch.save({"delta": {k: (p.detach() - before[k]).cpu()
                          for k, p in model.named_parameters()},
                "logs": {k: float(v) for k, v in logs.items()},
                "backend": torch.distributed.get_backend(),
                "device": str(dev)}, sys.argv[1])
torch.distributed.destroy_process_group()
"""


class Sgd:
    """SGD(1.0) in the optimizer's interface: the update is -grad, so the
    parameters' change is the step's gradient."""

    def init(self, params):
        from codd_torch.train import optim
        return optim.AdamState(0, {}, {})

    def trained_names(self, tree):
        return list(tree)

    def update(self, grads, state, params=None):
        return {k: -g for k, g in grads.items()}, state


def sgd_step(model, lc, batch):
    """One ``make_train_step`` step under ``Sgd``: the parameters before,
    the state and the logs."""
    from codd_torch.train import trainer
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = trainer.make_train_step(model, Sgd(), lc)
    state, logs = step(trainer.create_train_state(model, Sgd()), batch)
    return before, state, logs


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _dist_env(**extra):
    import os
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(cmd, env, label):
    """``cmd`` to its end within DIST_TIMEOUT; fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(Path(__file__).resolve().parent),
                          env=env, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dist ({label}): exit {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, secs


def dist_phase(dev):
    """(a) ``python -m torch.distributed.run --standalone --nproc_per_node=1
    -m codd_torch.tools.train`` over NCCL, 2 steps of
    configs/training_config.py (the volume lookup, so that no kernel of
    the step adds by atomics) on the entry phase's PNG data, against the
    same 2 steps without torchrun: ckpt_2's parameters, Adam's moments and
    data state equal in bits (deterministic cuDNN and ATen in both).
    (b) two ranks on the one card over gloo, one stereo-stage step under
    SGD with each rank holding 2 rows of the train phase's first batch,
    against one process on all 4 under ``deterministic()``: each
    parameter's change within 1e-4 of its norm (a norm counted as at least
    1e-5 of the largest), the loss and grad_norm to 1e-4."""
    import shutil

    import torch
    from codd_torch.models.builder import build_loss_config
    from codd_torch.train.checkpoint import STATE_FILE

    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    split = write_entry_dataset(DIST_DIR / "data")
    _, paths = entry_config(DIST_DIR / "data", split)
    det = DIST_DIR / "det_train.py"
    det.write_text(_DET_TRAIN)
    opts = ["--max-steps", "2", "--options", *paths, "evaluation.interval=0",
            "checkpoint.interval=2", "model.runtime.corr_impl=volume"]
    try:
        out1, s1 = _run([sys.executable, str(det), str(TRAINING_CONFIG),
                         "--work-dir", str(DIST_DIR / "one")] + opts,
                        _dist_env(), "one process")
        outn, sn = _run([sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc_per_node=1", str(det),
                         str(TRAINING_CONFIG), "--work-dir",
                         str(DIST_DIR / "nccl")] + opts, _dist_env(),
                        "torchrun, NCCL")
        if "backend nccl" not in outn:
            fail(f"dist (torchrun): no NCCL group in its log: {outn[-1500:]}")
        a, b = (torch.load(DIST_DIR / w / "ckpt_2" / STATE_FILE,
                           weights_only=True) for w in ("one", "nccl"))
        unequal = [k for k, v in a["params"].items()
                   if not torch.equal(v, b["params"][k])]
        unequal += [f"{part}.{k}" for part in ("mu", "nu")
                    for k, v in a["opt_state"][part].items()
                    if not torch.equal(v, b["opt_state"][part][k])]
        if unequal or a["data"] != b["data"] or b["step"] != 2:
            fail(f"dist (torchrun, NCCL): ckpt_2 differs from the run "
                 f"without torchrun: {unequal[:5]} ({len(unequal)})")
        lines = [l for l in outn.splitlines() if "step " in l or "rank" in l]
        print(f"  dist (a): torchrun --nproc_per_node=1 over NCCL, 2 steps "
              f"of training_config.py (corr_impl volume): {sn:.1f} s, "
              f"without torchrun {s1:.1f} s; ckpt_2's {len(a['params'])} "
              f"tensors, Adam's moments and data state equal in bits; "
              f"{lines}", flush=True)

        # (b) two ranks on the one card over gloo
        script = DIST_DIR / "gloo_rank.py"
        script.write_text(_GLOO_RANK)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(DIST_DIR / "gloo.pt")],
            cwd=str(Path(__file__).resolve().parent),
            env=_dist_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                          WORLD_SIZE=2, RANK=r, LOCAL_RANK=0),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        t0 = time.perf_counter()
        try:
            outs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        s2 = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            fail(f"dist (b): a rank failed: "
                 f"{[o[-2000:] for o in outs]}")
        two = torch.load(DIST_DIR / "gloo.pt", weights_only=True)
        model = build_model("stereo.py")
        lc = build_loss_config(model_cfg("stereo.py"))
        batch = train_batches(1, dev)[0]
        with deterministic():
            before, _, logs = sgd_step(model, lc, batch)
        one = {k: (p.detach() - before[k]).cpu()
               for k, p in model.named_parameters()}
        err, where = grads_apart(two["delta"], one, 1e-5, show=3)
        rl = abs(two["logs"]["loss"] - float(logs["loss"])) / abs(
            float(logs["loss"]))
        rg = abs(two["logs"]["grad_norm"] - float(logs["grad_norm"])) / abs(
            float(logs["grad_norm"]))
        print(f"  dist (b): two ranks on {two['device']} over "
              f"{two['backend']}, a stereo step under SGD on 2 + 2 rows of "
              f"B={TRAIN_B} at {TRAIN_H}x{TRAIN_W}: {s2:.1f} s; against one "
              f"process on the 4 rows: worst |change diff| / |change| "
              f"{err:.2e} at {where} (bound 1e-4), loss rel {rl:.2e}, "
              f"grad_norm rel {rg:.2e}", flush=True)
        if two["backend"] != "gloo" or err > 1e-4 or rl > 1e-4 or rg > 1e-4:
            fail("dist (b): the two-rank step is not the global batch's")
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    print(f"  dist: {time.perf_counter() - t_phase:.1f} s for the phase; "
          f"{smi_name_power()}", flush=True)


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


# ---------------------------------------------------------------------------
# weights: a reference CODD checkpoint through utils/port_weights.py
# ---------------------------------------------------------------------------

WEIGHTS_DIR = Path(__file__).resolve().parent / "build" / "weights_smoke"
WEIGHTS_STEPS = 2
# the point-cloud CLI's defaults (KITTI's fx times its baseline)
CALIB = 384.38


def reference_state_dict(sd):
    """The port's state_dict ``sd`` under the reference checkpoint's names
    (``utils/port_weights.py``'s tables read backward; the layouts are the
    reference's already), with BatchNorm's ``num_batches_tracked`` and the
    HITLoss plane-fit convs, as an mmcv checkpoint holds them."""
    import torch
    from codd_torch.losses.hitnet import plane_fit_kernels
    from codd_torch.utils import port_weights

    ref = {}
    for sub, table, dest in port_weights.SUBMODULES:
        for entry in table:
            bn = len(entry) > 2 and entry[2] == "bn"
            base = f"{dest}.{entry[1].replace('/', '.')}"
            leaves = (("weight", "bias", "running_mean", "running_var")
                      if bn else ("weight", "bias"))
            for leaf in leaves:
                if f"{base}.{leaf}" in sd:
                    ref[f"{sub}.{entry[0]}.{leaf}"] = sd[f"{base}.{leaf}"]
            if bn:
                ref[f"{sub}.{entry[0]}.num_batches_tracked"] = torch.tensor(0)
    for name, k in zip(("convx", "convy"), plane_fit_kernels()):
        ref[f"stereo.loss.{name}.weight"] = torch.from_numpy(k)[None, None]
    return ref


def weights_phase(dev):
    """The default model with seeded weights written as a reference
    checkpoint, converted by ``port_codd_checkpoint``, saved and loaded
    into a second model by ``train/checkpoint.py:restore_params``
    (``--load-from``'s loader); both streamed; the last frame's point
    cloud.  Returns the launches of the two streams."""
    import shutil
    import torch
    from codd_torch.losses.hitnet import plane_fit_kernels
    from codd_torch.models.builder import build_estimator
    from codd_torch.ops import kernels
    from codd_torch.train.checkpoint import restore_params
    from codd_torch.utils import port_weights, vis_point_cloud

    t0 = time.perf_counter()
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    WEIGHTS_DIR.mkdir(parents=True)
    try:
        model = build_model()
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        ref_path, port_path = (WEIGHTS_DIR / "reference.pth",
                               WEIGHTS_DIR / "port.pth")
        torch.save({"meta": {"epoch": 0}, "state_dict":
                    reference_state_dict(sd)}, ref_path)
        conv = port_weights.port_codd_checkpoint(
            torch.load(ref_path, map_location="cpu", weights_only=True))
        if conv["missing"]:
            fail(f"weights: port_codd_checkpoint missing {conv['missing'][:5]}"
                 f" ({len(conv['missing'])})")
        kx, ky = plane_fit_kernels()
        kernels_back = conv.get("hit_loss_kernels", {})
        if not (np.array_equal(kernels_back.get("convx"), kx)
                and np.array_equal(kernels_back.get("convy"), ky)):
            fail("weights: hit_loss_kernels are not the file's")
        torch.save(conv["state_dict"], port_path)
        second = build_estimator(model_cfg(), device="cuda", seed=1)
        restore_params(str(port_path), second)
        got = second.state_dict()
        off = [k for k, v in model.state_dict().items()
               if not torch.equal(got[k], v)]
        if off:
            fail(f"weights: {len(off)} tensors off the original's bits, "
                 f"e.g. {off[:3]}")
        n_tensors, mib = len(sd), ref_path.stat().st_size / 2 ** 20

        intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
        seq = frames(WEIGHTS_STEPS + 1, dev)
        kernels.reset_counts()
        outs = {label: stream(m, intr, seq)[2]
                for label, m in (("original", model), ("converted", second))}
        launches = kernels.counts()
        expect = dict(dict.fromkeys(kernels.KERNELS, 0),
                      tile_warp_cost=2 * 9 * (WEIGHTS_STEPS + 1),
                      corr_lookup=2 * 16 * WEIGHTS_STEPS,
                      gn_fused_solve=2 * 16 * WEIGHTS_STEPS,
                      splat_composite=2 * 2 * WEIGHTS_STEPS)
        if launches != expect:
            fail(f"weights: launch counts {launches} != expected {expect}")
        for t, (a, b) in enumerate(zip(outs["converted"], outs["original"])):
            a, b = a["pred_disp"], b["pred_disp"]
            if a.shape != (1, H, W, 1) or not torch.isfinite(a).all():
                fail(f"weights: frame {t} pred_disp {tuple(a.shape)} or "
                     "non-finite")
            share = float(((a - b).abs() > 1e-2 * (1 + b.abs())).float()
                          .mean())
            if share > 1e-3:
                fail(f"weights: frame {t} pred_disp moved on {share:.2e} of "
                     "the pixels")
        disp = outs["converted"][-1]["pred_disp"][0, ..., 0]
        pts, col = vis_point_cloud.disparity_to_points(
            disp, intr[0].tolist(), CALIB)
        cpu_pts, cpu_col = vis_point_cloud.disparity_to_points(
            disp.cpu(), intr[0].tolist(), CALIB)
        if not (np.array_equal(pts, cpu_pts)
                and np.array_equal(col, cpu_col)):
            fail("weights: the point cloud on the card is not the CPU's")
        ply = WEIGHTS_DIR / f"frame{WEIGHTS_STEPS}.ply"
        vis_point_cloud.write_ply(str(ply), pts, col)
        header = 200 + len(str(len(pts)))
        if not 15 * len(pts) < ply.stat().st_size <= 15 * len(pts) + header:
            fail(f"weights: {ply.name} holds {ply.stat().st_size} bytes for "
                 f"{len(pts)} points")
    finally:
        shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    print(f"  reference checkpoint: {n_tensors} tensors ({mib:.1f} MiB) "
          "converted with no missing prefix, loaded by restore_params, every "
          "tensor the original's bits", flush=True)
    print(f"  first_step + {WEIGHTS_STEPS} steps on both models: pred_disp "
          f"agrees; launches {launches}", flush=True)
    print(f"  point cloud of frame {WEIGHTS_STEPS}: {len(pts)} points "
          f"(the CPU's bits); phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def profile_step(model, intr, seq, out_file: Path):
    """torch.profiler over one streaming step (``profile_call``)."""
    import torch
    carry, _ = model.first_step(*seq[0], intr)
    model.step(carry, *seq[1], intr)
    torch.cuda.synchronize()
    profile_call(lambda: model.step(carry, *seq[1], intr),
                 f"one step at {H}x{W}", out_file)


def profile_call(run, label: str, out_file: Path):
    """torch.profiler over one call of ``run`` (warmed up by the caller):
    device time by kernel, the hand kernels' share, and the device's idle
    share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
            "tile_warp_cost_backward_kernel": "tile_warp_cost_backward",
            "corr_lookup_kernel": "corr_lookup",
            "corr_lookup_backward_kernel": "corr_lookup_backward",
            "gn_fused_solve_kernel": "gn_fused_solve",
            "splat_composite_walk": "splat_composite",
            "splat_composite_lanes": "splat_composite",
            "splat_composite_backward_": "splat_composite_backward",
            "gn_window_aggregate_kernel": "gn_window_aggregate",
            "corr_patch_lookup_kernel": "corr_patch_lookup",
            "gn_window_aggregate_backward_kernel":
                "gn_window_aggregate_backward",
            "gn_window_aggregate_backward_bf16_kernel":
                "gn_window_aggregate_backward_bf16",
            "gn_backward_bf16_keys_kernel":
                "gn_window_aggregate_backward_bf16",
            "corr_patch_lookup_backward_kernel":
                "corr_patch_lookup_backward",
            "corr_patch_lookup_coords_backward_":
                "corr_patch_lookup_coords_backward"}
    mine: dict = {}
    for k, v in hand.items():
        mine[v] = mine.get(v, 0.0) + sum(r[1] for r in rows if k in r[0])
    cats: dict = {}
    for key, ms, n in rows:
        c = cats.setdefault(_category(key, hand), [0.0, 0])
        c[0] += ms
        c[1] += n
    lines = [f"{label}: wall {wall_ms:.3f} ms, device busy "
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
    # cuDNN's implicit-GEMM, direct and FFT convolutions (weight
    # gradients too) and its layout transposes; the complex (float2, cf32)
    # GEMM/GEMV and transforms are the FFT convolutions' products
    if any(k in kernel for k in ("cudnn", "fprop", "dgrad", "wgrad",
                                 "convolve", "DSE::", "nhwcToNchw",
                                 "nchwToNhwc", "region_transform", "float2",
                                 "cf32")):
        return "cuDNN convolutions"
    if "gemm" in kernel or "gemv" in kernel:
        return "cuBLAS GEMM / GEMV"
    return "ATen elementwise / reduce / copy / gather"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,main,eval,plain,train,entry,bench,"
                            "dist,weights",
                    help="comma list of kernels, main, eval, plain, train, "
                         "entry, bench, dist, weights, profile (profile "
                         "writes "
                         "chiprun_out/"
                         "profile_step*.txt, the bf16 model's too, and "
                         "streams both configurations in turns), loader "
                         "(with entry: the in-memory step beside the "
                         "loader's thread and beside a loading process)")
    ap.add_argument("--steps", type=int, default=3,
                    help="step calls of the main path after first_step")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    unknown = phases - {"kernels", "main", "eval", "plain", "train", "entry",
                        "bench", "dist", "weights", "profile", "loader"}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    if "loader" in phases and "entry" not in phases:
        fail("the loader phase needs the entry phase")

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
    print(f"[2/6] built {len({v[0] for v in kernels.KERNELS.values()})} "
          f"sources ({len(kernels.KERNELS)} kernels) in "
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
    train_launches = {}
    if "train" in phases:
        print(f"[train] {TRAIN_STEPS} training steps a stage at B={TRAIN_B}, "
              f"T={TRAIN_T}, {TRAIN_H}x{TRAIN_W}: the stereo, fusion, "
              "motion, joint and full joint stages", flush=True)
        train_launches = train_phase(dev, Path(__file__).resolve().parent
                                     / "chiprun_out" if "profile" in phases
                                     else None)
    entry_launches = {}
    if "entry" in phases:
        print(f"[entry] python -m codd_torch.tools.train's path: "
              f"configs/training_config.py on {ENTRY_SEQS}x{ENTRY_FRAMES} "
              f"PNG frames of {ENTRY_H}x{ENTRY_W}, {ENTRY_STEPS} steps with "
              "validation, a resume, one CLI step", flush=True)
        entry_launches = entry_phase(dev, "loader" in phases)
    bf16_launches = {}
    if "bench" in phases:
        print("[bench] tools/bench.py at 384x1280: f32, bf16, bf16 batch 2",
              flush=True)
        bf16_launches = bench_phase()
    if "dist" in phases:
        print("[dist] torchrun --nproc_per_node=1 over NCCL against one "
              "process, 2 training steps; two ranks on the one card over "
              "gloo, one stereo step", flush=True)
        dist_phase(dev)
    weights_launches = {}
    if "weights" in phases:
        print(f"[weights] a reference checkpoint of the default model "
              f"through port_codd_checkpoint and restore_params; first_step "
              f"+ {WEIGHTS_STEPS} steps at {H}x{W} on both models; the point "
              "cloud", flush=True)
        weights_launches = weights_phase(dev)
    if "profile" in phases:
        if model is None and eval_model is None and "train" not in phases:
            fail("the profile phase needs the main, eval or train phase")
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
    # the default path's plus the evaluation path's plus the training
    # steps' plus the training entry's plus the converted checkpoint's
    # streams (the backward launches in training only)
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = (launches.get(r["name"], 0)
                         + eval_launches.get(r["name"], 0)
                         + train_launches.get(r["name"], 0)
                         + entry_launches.get(r["name"], 0)
                         + weights_launches.get(r["name"], 0))
        needs = ({"train"} if "_backward" in r["name"]
                 else {"main", "eval"})
        if r["launches"] == 0 and needs <= phases:
            fail(f"{r['name']}: launched no time on the main paths")
        if r["name"] == "tile_warp_cost" and bf16_launches:
            r["launches_bf16"] = bf16_launches["tile_warp_cost"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_quarter", "bound_ms_quarter", "launches_bf16",
            "max_abs_err_bf16_exact", "unequal_share_bf16_exact",
            "ms_bf16_exact", "plain_ms_bf16_exact", "max_abs_err_bf16_pallas",
            "unequal_share_bf16_pallas", "ms_bf16_pallas",
            "plain_ms_bf16_pallas", "bound_ms_bf16", "ms_bf16",
            "plain_ms_bf16", "max_abs_err_bf16", "unequal_share_bf16",
            "ms_bf16_smooth", "ms_bf16_train", "bound_ms_bf16_train",
            "ms_smooth", "ms_scattered", "one_chunk_share", "global_adds",
            "ms_cold", "ms_dense", "bound_ms_dense", "ms_f32_form",
            "beyond_f32_share_random",
            "worst_over_terms_random", "beyond_f32_share_smooth",
            "worst_over_terms_smooth", "registers", "spill_bytes")
    print(f"chip_smoke: phases {','.join(sorted(phases))} in "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
