"""Throughput benchmark of the port (counterpart of ``bench.py``).

    python -m codd_torch.tools.bench [--height 384] [--width 1280]
        [--iters 50] [--warmup 5] [--gn-iters 16] [--max-disp 320]
        [--mode streaming|frame0] [--batch B] [--bf16] [--corr-impl ...]
        [--gn-impl ...] [--gn-bf16] [--gn-unroll N] [--splat-impl ...]
        [--splat-impl-lr ...] [--init-cost ...] [--tile-warp ...]
        [--profile-dir D] [--device cuda|cpu]

The protocol is ``bench.py``'s: seeded random weights (seed 0), 8 buffered
random frame pairs from ``numpy.random.RandomState(0)`` in rotation, f32
intrinsics ``[[450, 450, W/2, H/2]] * B``, ``first_step`` on the first
pair, ``--warmup`` calls, then ``--iters`` timed calls of ``step``
(``--mode streaming``) or ``first_step`` (``--mode frame0``) with one
``torch.cuda.synchronize()`` at the end.  ``--batch B`` runs B independent
streams in one batch; the metric counts frames of all of them.

``--bf16`` casts the parameters and the frames to bf16 (the intrinsics
stay f32), as ``bench.py`` does; compute follows the dtypes as
``codd_tpu`` does (``utils/precision.py``).  The runtime knobs go through
``build_estimator``'s ``model.runtime``, which raises on an unknown value.

A second loop of ``--iters`` calls syncs after every call.  The lines
before the last print its median and spread of ms a call (host clock),
the stream's ms a call between CUDA events, the hand kernels' launches a
call (``ops/kernels.py`` counts), the peak device memory, and the card's
name and power limit.  ``--profile-dir D`` writes a ``torch.profiler``
trace of 3 calls (``D/trace.json``) and its table by device time
(``D/profile.txt``), the port's ``codd.*`` spans among them
(``utils/spans.py``).  The last line is ``bench.py``'s JSON line:
``{"metric": "fps_<mode>[_b<B>]_kitti_<H>x<W>", "value", "unit": "fps",
"vs_baseline"}`` against 60 frames/s.  Without a card the command fails
unless ``--device cpu`` is given; CPU numbers are no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

NBUF = 8              # distinct buffered frame pairs, in rotation
BASELINE_FPS = 60.0   # bench.py's baseline


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CODD throughput (PyTorch)")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--gn-iters", type=int, default=16)
    p.add_argument("--max-disp", type=int, default=320)
    p.add_argument("--mode", choices=["streaming", "frame0"],
                   default="streaming")
    p.add_argument("--batch", type=int, default=1,
                   help="independent concurrent streams; the metric counts "
                        "frames of all of them")
    p.add_argument("--bf16", action="store_true",
                   help="cast the parameters and the frames to bfloat16")
    p.add_argument("--splat-impl", default="xla_gather")
    p.add_argument("--splat-impl-lr", default="")
    p.add_argument("--init-cost", default="auto")
    p.add_argument("--tile-warp", default="auto",
                   help="kernel 1's bf16 form: pallas, or the others "
                        "(tile_warping step by step in bf16)")
    p.add_argument("--corr-impl", default="auto")
    p.add_argument("--gn-impl", default="auto")
    p.add_argument("--gn-unroll", type=int, default=1)
    p.add_argument("--gn-bf16", action="store_true",
                   help="bf16 GN attention scores")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of 3 calls here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def model_config(args) -> Dict[str, Any]:
    """The ``model`` config ``bench.py``'s flags describe."""
    return {
        "stereo": {"max_disp": args.max_disp},
        "motion": {"type": "Motion", "iters": args.gn_iters},
        "fusion": {"type": "Fusion"},
        "runtime": {
            "init_cost_variant": args.init_cost,
            "tile_warp_variant": args.tile_warp,
            "gn_impl": args.gn_impl, "gn_bf16_scores": args.gn_bf16,
            "corr_impl": args.corr_impl, "gn_unroll": args.gn_unroll,
            "splat_impl": args.splat_impl,
            "splat_impl_lr": args.splat_impl_lr,
        },
    }


def card() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def metric_name(mode: str, batch: int, H: int, W: int) -> str:
    return (f"fps_{mode}_kitti_{H}x{W}" if batch == 1 else
            f"fps_{mode}_b{batch}_kitti_{H}x{W}")


def run(args, log=print) -> Dict[str, Any]:
    """Build, warm up and time the model as the flags say; ``log`` gets
    the lines before the last.  Returns the JSON line's dict under
    ``"line"`` and the measurements beside it."""
    from ..models.builder import build_estimator
    from ..ops import kernels
    from ..ops.gn import resolve_impl
    from ..utils.precision import cast_floats

    H, W, B = args.height, args.width, args.batch
    if args.gn_bf16 and resolve_impl(args.gn_impl, 32, W // 8) == "dense":
        log(f"WARNING: --gn-bf16 is a no-op: gn impl resolves to 'dense' at "
            f"this shape (W/8={W // 8}); bf16 scores apply only to the "
            "windowed/pallas paths")
    model = build_estimator(model_config(args), device=args.device, seed=0)
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    rng = np.random.RandomState(0)
    put = lambda a: torch.from_numpy(a).to(dev)
    lbuf = [put(rng.rand(B, H, W, 3).astype(np.float32))
            for _ in range(NBUF)]
    rbuf = [put(rng.rand(B, H, W, 3).astype(np.float32))
            for _ in range(NBUF)]
    intr = torch.tensor([[450.0, 450.0, W / 2.0, H / 2.0]] * B,
                        dtype=torch.float32, device=dev)
    if args.bf16:
        cast_floats(model)
        lbuf, rbuf = cast_floats(lbuf), cast_floats(rbuf)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    state = {}
    state["carry"], _ = model.first_step(lbuf[0], rbuf[0], intr)

    def call(i):
        if args.mode == "frame0":
            state["carry"], out = model.first_step(
                lbuf[i % NBUF], rbuf[i % NBUF], intr)
        else:
            state["carry"], out = model.step(
                state["carry"], lbuf[i % NBUF], rbuf[i % NBUF], intr)
        return out["pred_disp"]

    for i in range(args.warmup):
        disp = call(i)
    sync()

    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        os.makedirs(args.profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            for i in range(3):
                call(i)
            sync()
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        key = "device_time_total" if cuda else "cpu_time_total"
        with open(os.path.join(args.profile_dir, "profile.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=key, row_limit=60))
        log(f"profile: {args.profile_dir}/trace.json, profile.txt")

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(args.iters):
        disp = call(i)
    sync()
    dt = time.perf_counter() - t0
    float(disp.reshape(-1)[0])  # the value depends on the whole chain
    fps = args.iters * B / dt

    # the same calls again, each synced: the spread, the stream's time
    host_ms: List[float] = []
    stream_ms: List[float] = []
    kernels.reset_counts()
    for i in range(args.iters):
        if cuda:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        t = time.perf_counter()
        call(i)
        if cuda:
            ev1.record()
        sync()
        host_ms.append((time.perf_counter() - t) * 1e3)
        if cuda:
            stream_ms.append(ev0.elapsed_time(ev1))
    launches = {k: v / args.iters for k, v in kernels.counts().items() if v}

    device = (torch.cuda.get_device_name(dev) if cuda else "cpu")
    res: Dict[str, Any] = {
        "device": device,
        "card": card() if cuda else None,
        "ms_median": statistics.median(host_ms),
        "ms_min": min(host_ms), "ms_max": max(host_ms),
        "stream_ms_median": (statistics.median(stream_ms) if stream_ms
                             else None),
        "launches_per_call": launches,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if cuda else None),
        "line": {
            "metric": metric_name(args.mode, B, H, W),
            "value": round(fps, 3),
            "unit": "fps",
            "vs_baseline": round(fps / BASELINE_FPS, 4),
        },
    }
    prec = "bf16" if args.bf16 else "f32"
    log(f"device: {device}" + (f" ({res['card']})" if cuda else
                               " (not a device metric)"))
    log(f"{args.mode} {prec} B={B} {H}x{W}, {args.gn_iters} GN iterations: "
        f"{fps:.3f} frames/s over {args.iters} calls, one sync")
    log(f"ms a call, each synced (host clock): median {res['ms_median']:.3f}"
        f", min {res['ms_min']:.3f}, max {res['ms_max']:.3f}")
    if cuda:
        log(f"stream ms a call (CUDA events): median "
            f"{res['stream_ms_median']:.3f}; peak memory "
            f"{res['peak_gib']:.3f} GiB")
    else:
        log("stream ms a call and peak memory: not measured (cpu)")
    log("hand-kernel launches a call: " + json.dumps(launches))
    return res


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        res = run(args)
    except RuntimeError as e:
        if "CUDA is not available" not in str(e):
            raise
        print(f"error: {e} (or run with --device cpu)", file=sys.stderr)
        return 1
    print(json.dumps(res["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
