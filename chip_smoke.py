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
     the least time the card could take (bytes over 3.35 TB/s or f32
     operations over 67 TFLOP/s, whichever is larger);
  4. main path: CODD from configs/models/codd.py (max_disp 320, 16 GN
     iterations, fusion width 32) with seeded random weights on the card,
     ``first_step`` and ``--steps`` ``step`` calls at 384x1280, B=1, with
     the launch count of every kernel, ms/frame and peak memory;
  5. plain: one frame pair at full width through the plain versions on
     the card, its fused disparity held against the kernel run's.

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
H, W = 384, 1280


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
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
    print(f"  {name}: max_abs_err {max_err:.3e}  max|ref| {max_ref:.3e}  "
          f"rel {max_err / max(max_ref, 1e-30):.3e}  out of tol "
          f"{int(bad.sum())}/{bad.numel()} (atol {atol:g} + rtol {rtol:g}*|ref|)")
    if bool(bad.any()):
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


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
    rows.append(dict(
        name="tile_warp_cost", source="codd_torch/csrc/tile_warp.cu",
        replaces="codd_tpu/ops/pallas/tile_warp.py:123", max_abs_err=err,
        ms=cuda_ms(lambda: tile_warp.tile_warp_cost(hyp3, fl, fr)),
        plain_ms=cuda_ms(lambda: tile_warp.tile_warp_cost_plain(hyp3, fl, fr)),
        bytes=nbytes, flops=flops, library_ms=None))

    # -- kernel 2: corr lookup in the level-0 volume (48x160 queries) --
    h8, w8 = H // 8, W // 8
    f1, f2 = randn(1, h8, w8, 128), randn(1, h8, w8, 128)
    vols = corr.build_corr_pyramid(f1, f2, 4, 3)
    ys, xs = torch.meshgrid(torch.arange(h8, device=dev),
                            torch.arange(w8, device=dev), indexing="ij")
    coords = (torch.stack([xs, ys], -1)[None].float()
              + randn(1, h8, w8, 2, scale=6.0)).contiguous()
    got = corr.corr_lookup_level(vols[0], coords, 3, 1.0)
    ref = corr.corr_lookup_level_plain(vols[0], coords, 3)
    torch.cuda.synchronize()
    # the same bf16 taps and the same bilinear arithmetic order
    err = _compare("corr_lookup", got, ref, 1e-5, 1e-6)
    n = h8 * w8
    rows.append(dict(
        name="corr_lookup", source="codd_torch/csrc/corr_lookup.cu",
        replaces="codd_tpu/ops/pallas/corr_select.py:60", max_abs_err=err,
        ms=cuda_ms(lambda: corr.corr_lookup_level(vols[0], coords, 3, 1.0)),
        plain_ms=cuda_ms(lambda: corr.corr_lookup_level_plain(
            vols[0], coords, 3)),
        bytes=n * (64 * 2 + 2 * 4 + 49 * 4), flops=n * 49 * 9,
        library_ms=None))

    # -- kernel 3: fused GN aggregate + solve (48x160, C=32) --
    intr8 = torch.tensor([[721.5 / 8, 721.5 / 8, 609.6 / 8, 172.9 / 8]],
                         device=dev)
    depth = rand(1, h8, w8, lo=2.0, hi=60.0)
    Ts = se3.exp(randn(1, h8, w8, 6, scale=0.01))
    target = (project(se3.act(Ts, inv_project(depth, intr8)), intr8)
              + randn(1, h8, w8, 3, scale=0.5))
    weight = rand(1, h8, w8, 3)
    vals = gn.build_vals(Ts, target, weight, depth, intr8).contiguous()
    ae = randn(1, h8, w8, 32, scale=1.0 / 8).contiguous()
    got = gn.gn_fused_solve(ae, vals)
    ref = gn.gn_fused_solve_plain(ae, vals)
    torch.cuda.synchronize()
    # ~4000-term f32 sums in another order, then a damped 6x6 solve
    err = _compare("gn_fused_solve", got, ref, 1e-5, 1e-3)
    ky = np.minimum(np.arange(h8) + 32, h8 - 1) - np.maximum(
        np.arange(h8) - 32, 0) + 1
    kx = np.minimum(np.arange(w8) + 32, w8 - 1) - np.maximum(
        np.arange(w8) - 32, 0) + 1
    pairs = float(ky.sum() * kx.sum())
    rows.append(dict(
        name="gn_fused_solve", source="codd_torch/csrc/gn_fused.cu",
        replaces="codd_tpu/ops/pallas/gn_fused.py:214", max_abs_err=err,
        ms=cuda_ms(lambda: gn.gn_fused_solve(ae, vals)),
        plain_ms=cuda_ms(lambda: gn.gn_fused_solve_plain(ae, vals)),
        bytes=4 * n * (32 + 27 + 6),
        # per pair: 32-wide dot (64), logit (3), sigmoid (3), 27 FMAs (54);
        # per query: norm (64) and the damped solve (~200)
        flops=pairs * 124 + n * 264, library_ms=None))

    # -- kernel 4: splat compositor at the full-res call (C=6, r=1) --
    intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
    depth = rand(1, H, W, lo=2.0, hi=60.0)
    X2 = se3.act(se3.exp(randn(1, H, W, 6, scale=0.01)),
                 inv_project(depth, intr)).reshape(-1, 3)
    feat = randn(H * W, 6)
    order, offsets, alpha, Z = splat.sort_fragments(X2, intr[0], H, W, 1.0)
    args = (order, offsets, alpha, Z.contiguous(), feat)
    got = splat.composite(*args)
    ref = splat.composite_plain(*args)
    torch.cuda.synchronize()
    # same fragment order; the plain version sums log-transmittance in f64
    err = _compare("splat_composite", got, ref, 1e-5, 1e-4)
    M = int(offsets[-1])
    run = (offsets[1:] - offsets[:-1]).clamp(max=8)
    rows.append(dict(
        name="splat_composite", source="codd_torch/csrc/splat_composite.cu",
        replaces="codd_tpu/ops/pallas/splat_composite.py:165",
        max_abs_err=err, ms=cuda_ms(lambda: splat.composite(*args)),
        plain_ms=cuda_ms(lambda: splat.composite_plain(*args)),
        bytes=8 * M + 4 * M + 8 * (H * W + 1) + 4 * Z.numel()
        + 4 * feat.numel() + 4 * H * W * (6 + 2),
        flops=float(run.sum()) * (2 * 6 + 6), library_ms=None))

    for r in rows:
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("bytes"), r.pop("flops"))
        print(f"  {r['name']}: {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
              f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the streaming cascade
# ---------------------------------------------------------------------------

def frames(n: int, dev):
    """Seeded stereo frames of a smooth textured plane: the right view is
    the left one shifted by 8 + t whole pixels (disparity 8 + t), and the
    camera pans 2 pixels a frame."""
    import torch
    g = torch.Generator().manual_seed(1)
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
    """Route the four hot ops to their plain PyTorch versions (phase 5)."""
    from codd_torch.models.stereo import hitnet
    from codd_torch.ops import corr, gn, splat, tile_warp

    def corr_plain(vol, coords, radius=3, scale=1.0, out=None, offset=0):
        res = corr.corr_lookup_level_plain(vol, coords * scale, radius)
        out[..., offset:offset + res.shape[-1]] = res
        return out

    saved = (hitnet.tile_warp_cost, corr.corr_lookup_level,
             gn.gn_fused_solve, splat.composite)
    hitnet.tile_warp_cost = tile_warp.tile_warp_cost_plain
    corr.corr_lookup_level = corr_plain
    gn.gn_fused_solve = gn.gn_fused_solve_plain
    splat.composite = splat.composite_plain
    try:
        yield
    finally:
        (hitnet.tile_warp_cost, corr.corr_lookup_level, gn.gn_fused_solve,
         splat.composite) = saved


def main_path(dev, steps: int):
    import torch
    from codd_torch.config import load_config
    from codd_torch.models.builder import build_estimator
    from codd_torch.ops import kernels

    cfg = load_config(str(Path(__file__).resolve().parent / "configs"
                          / "models" / "codd.py"))
    model = build_estimator(cfg["model"], device="cuda", seed=0)
    intr = torch.tensor([[721.5, 721.5, 609.6, 172.9]], device=dev)
    seq = frames(steps + 1, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_counts()
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
    launches = kernels.counts()

    expect = {"tile_warp_cost": 9 * (steps + 1), "corr_lookup": 64 * steps,
              "gn_fused_solve": 16 * steps, "splat_composite": 2 * steps}
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
    return model, intr, seq, launches


def plain_check(model, intr, seq):
    import torch
    carry, _ = model.first_step(*seq[0], intr)
    _, out_k = model.step(carry, *seq[1], intr)
    with plain_versions():
        carry, _ = model.first_step(*seq[0], intr)
        _, out_p = model.step(carry, *seq[1], intr)
    torch.cuda.synchronize()
    for key in ("pred_curr", "pred_warp", "pred_disp"):
        a, b = out_k[key], out_p[key]
        err = (a - b).abs()
        # random weights: argmax/floor decisions on near-ties may flip on
        # f32 sum-order differences, so a small share of pixels may move
        share = float((err > 1e-2 * (1 + b.abs())).float().mean())
        print(f"  {key}: max_abs_err {float(err.max()):.3e}  median "
              f"{float(err.median()):.3e}  share > 1e-2*(1+|plain|) {share:.2e}")
        if not torch.isfinite(a).all() or share > 1e-3:
            fail(f"{key}: kernel run disagrees with the plain run")


def profile_step(model, intr, seq, out_dir: Path):
    """torch.profiler over one step: device time by kernel, the four hand
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
            "splat_composite_kernel": "splat_composite"}
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
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "profile_step.txt", "w") as f:
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
    ap.add_argument("--phases", default="kernels,main,plain",
                    help="comma list of kernels, main, plain, profile "
                         "(profile writes chiprun_out/profile_step.txt)")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    try:
        import torch
        from codd_torch.ops import kernels
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    print(f"[1/5] device: {name} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    kernels.load(verbose=True)
    print(f"[2/5] built {len(kernels.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    if "kernels" in phases:
        print("[3/5] kernels against their plain versions", flush=True)
        rows = kernel_checks(dev)
    launches = {}
    if "main" in phases:
        print(f"[4/5] streaming cascade 384x1280, first_step + {args.steps} "
              "steps", flush=True)
        model, intr, seq, launches = main_path(dev, args.steps)
        if "plain" in phases:
            print("[5/5] one frame pair through the plain versions", flush=True)
            plain_check(model, intr, seq)
        if "profile" in phases:
            print("[profile] one step under torch.profiler", flush=True)
            profile_step(model, intr, seq,
                         Path(__file__).resolve().parent / "chiprun_out")
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches.get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
