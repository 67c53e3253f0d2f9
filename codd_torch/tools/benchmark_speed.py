"""Speed benchmark from a model config (counterpart of
``benchmark_speed.py``).

    python -m codd_torch.tools.benchmark_speed [CONFIG] [--height 512]
        [--width 640] [--iters 200] [--warmup 5] [--streaming]
        [--device cuda|cpu]

Builds the model of CONFIG (default ``configs/models/codd.py``) with
seeded random weights, feeds 8 buffered random frame pairs in rotation,
and prints ``Overall fps: ...`` over ``--iters`` calls after ``--warmup``,
with one ``torch.cuda.synchronize()`` at the end.  Each call is
``first_step`` (the frame-0 path the original benchmark measures) or,
with ``--streaming``, a ``step`` of the full cascade.  Without a card
the command fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

NBUF = 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CODD speed (PyTorch)")
    p.add_argument("config", nargs="?", default="configs/models/codd.py")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import load_config
    from ..models.builder import build_estimator

    cfg = load_config(args.config)
    try:
        model = build_estimator(cfg["model"], device=args.device)
    except RuntimeError as e:
        print(f"error: {e} (or run with --device cpu)", file=sys.stderr)
        return 1
    dev = next(model.parameters()).device
    H, W = args.height, args.width
    rng = np.random.RandomState(0)
    lbuf = [torch.from_numpy(rng.rand(1, H, W, 3).astype(np.float32)).to(dev)
            for _ in range(NBUF)]
    rbuf = [torch.from_numpy(rng.rand(1, H, W, 3).astype(np.float32)).to(dev)
            for _ in range(NBUF)]
    intr = torch.tensor([[450.0, 450.0, W / 2, H / 2]], device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    carry, _ = model.first_step(lbuf[0], rbuf[0], intr)

    def call(c, i):
        if args.streaming:
            return model.step(c, lbuf[i % NBUF], rbuf[i % NBUF], intr)
        return model.first_step(lbuf[i % NBUF], rbuf[i % NBUF], intr)

    for i in range(args.warmup):
        carry, _ = call(carry, i)
    sync()
    t0 = time.perf_counter()
    for i in range(args.iters):
        carry, _ = call(carry, i)
    sync()
    print(f"Overall fps: {args.iters / (time.perf_counter() - t0):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
