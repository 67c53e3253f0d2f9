"""Bits of kernel 1's bf16 backward (1b) from process to process.

    python -m codd_torch.tools.tile_warp_bits [--source PATH] [--poison]
    python -m codd_torch.tools.tile_warp_bits --device cpu

Prints one JSON line: the SHA-1 (12 hex digits) of 1b's three outputs
(dhyp3, dfea_l, dfea_r) on two launches and of its plain version's on two
runs, at the training call (4 x 384x768, C=16) on
``tests/test_torch_gpu.py``'s random field (seed 0, disparities -20 to
W + 20: taps past both edges), the count of NaN in each, and a few
elements of dfea_r where the four do not agree.  Run it in
several processes and compare the lines: a side whose hashes move between
launches or processes has bits that are not fixed.  ``--source`` launches
another revision's ``csrc/tile_warp.cu`` (a file, or a directory holding
it; built as ``kernel_cutouts`` builds its copies); ``--poison`` first
fills the caching allocator's blocks with bf16 NaN bits, so that an
output element the kernel never writes shows as NaN; ``--device cpu``
hashes the plain version on the CPU only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

from ..ops import tile_warp
from . import kernel_cutouts


def _digest(t) -> str:
    return hashlib.sha1(t.detach().contiguous().cpu().view(torch.int16)
                        .numpy().tobytes()).hexdigest()[:12]


def _sums(outs):
    return {"sha1": [_digest(t) for t in outs],
            "nan": [int(torch.isnan(t).sum()) for t in outs]}


def _launcher(source: Path, args):
    """1b of ``source`` through its C launcher, outputs from torch.empty."""
    if source.is_dir():
        source = source / "tile_warp.cu"
    lib = kernel_cutouts.build("tile_warp", source, ["as_is"])["as_is"]
    g, hyp3, fl, fr = args
    B, H, W, C = fr.shape
    cg = tile_warp.backward_channel_group(W, C)

    def launch():
        outs = [torch.empty_like(t) for t in (hyp3, fl, fr)]
        err = lib.tile_warp_cost_backward_launch(
            hyp3.data_ptr(), fl.data_ptr(), fr.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in outs), B, H, W, C, cg,
            tile_warp.FORMS["exact"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tile_warp_cost_backward: error {err}")
        return outs
    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=None,
                    help="another revision's tile_warp.cu or csrc directory")
    ap.add_argument("--poison", action="store_true",
                    help="fill the allocator's blocks with NaN bits first")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        plain = tile_warp.tile_warp_cost_backward_plain(
            *kernel_cutouts.training_call_inputs("cpu"))
        print(json.dumps({"plain_cpu": _sums(plain)}))
        return 0
    if not torch.cuda.is_available():
        print("tile_warp_bits: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if args.poison:
        junk = [torch.full((64 << 20,), -1, dtype=torch.int16, device=dev)
                for _ in range(24)]
        torch.cuda.synchronize()
        del junk
    ins = kernel_cutouts.training_call_inputs(dev)
    launch = (_launcher(args.source, ins) if args.source is not None
              else lambda: tile_warp.tile_warp_cost_backward(*ins))
    kernel = [launch() for _ in range(2)]
    plain = [tile_warp.tile_warp_cost_backward_plain(*ins) for _ in range(2)]
    torch.cuda.synchronize()
    print(json.dumps({"kernel": [_sums(o) for o in kernel],
                      "plain": [_sums(o) for o in plain],
                      "apart": _apart([o[2] for o in kernel + plain])}))
    return 0


def _apart(outs, n: int = 4):
    """Up to ``n`` elements of dfea_r where the two launches and the two
    plain runs do not all agree: [index, the four values]."""
    bits = torch.stack([t.view(torch.int16) for t in outs])
    idx = (bits != bits[:1]).any(0).nonzero()[:n]
    return [[i.tolist(), [float(t[tuple(i)]) for t in outs]] for i in idx]


if __name__ == "__main__":
    sys.exit(main())
