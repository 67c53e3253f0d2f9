"""The work counts: each hand kernel's bytes and operations, and the whole
step's FLOPs, counted on the reference at the cell's own shapes.

The per-kernel arithmetic is a frozen copy of what ``chip_smoke.py``'s
phase 3 uses for PERF.md section 6's "bound" column (``bound_ms`` and the
``bytes=`` / ``flops=`` of each row), applied to each call's own inputs:
bound = max(bytes / 3.35 TB/s, the sum over kinds of operations of
count / the peak of the unit that runs them).  Peaks are NVIDIA's data
sheet for the H100 SXM at its 700 W limit.

``counted_work`` runs one call of the reference with each op that a hand
kernel computes in the program wrapped: the wrapper records the call's
bound and operations and takes the FLOPs that ``torch.utils.flop_counter``
saw inside the op's plain form off the model's count, so the op counts
once, by its own arithmetic."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "F32_3XTF32_PER_S", "bound_s", "Work",
           "counted_work", "WORK"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # dense TF32 on the tensor cores
# an f32 product to f32 accuracy on the tensor cores: three TF32 products
F32_3XTF32_PER_S = TF32_FLOPS_PER_S / 3


def bound_s(nbytes: float, flops) -> float:
    """max(bytes / the memory rate, sum of count / peak); ``flops`` a list
    of (count, peak)."""
    return max(nbytes / HBM_BYTES_PER_S, sum(f / p for f, p in flops))


def _window_pairs(B: int, h: int, w: int, radius: int = 32) -> float:
    ky = np.minimum(np.arange(h) + radius, h - 1) - np.maximum(np.arange(h) - radius, 0) + 1
    kx = np.minimum(np.arange(w) + radius, w - 1) - np.maximum(np.arange(w) - radius, 0) + 1
    return float(B * ky.sum() * kx.sum())


# -- each kernel's arithmetic: (bytes, [(operations, peak), ...]) --

def tile_warp_cost(hyp3, fea_l, fea_r):
    B, H, W, C = fea_r.shape
    npx = B * H * W
    out = hyp3.numel() // 3 * 48
    size = fea_r.element_size()
    return size * (2 * npx * C + hyp3.numel() + out), [(npx * (18 * C + 10), F32_FLOPS_PER_S)]


def corr_lookup_levels(vols, coords, radius=3):
    N = coords[..., 0].numel()
    L = len(vols)
    return float(N * (L * (64 * 2 + 49 * 4) + 2 * 4)), [(L * N * 49 * 9, F32_FLOPS_PER_S)]


def _gn(ae, vals, out_w, per_query, radius=32):
    B, h, w, _ = ae.shape
    n = B * h * w
    pairs = _window_pairs(B, h, w, radius)
    return (4 * n * (32 + 27 + out_w),
            [(pairs * (32 + 54), F32_3XTF32_PER_S), (pairs * 3 + n * per_query, F32_FLOPS_PER_S)])


def gn_fused_solve(ae, vals, radius=32, lm=1e-4, ep=10.0):
    return _gn(ae, vals, 6, 264, radius)


def splat_composite(order, offsets, alpha, z, feat, points_per_pixel=8):
    """Per pixel its offset and outputs; the ids and alphas of the fragments
    it composites (the first ``points_per_pixel`` of each run); the feature
    rows of their distinct points; the depths of the distinct points in
    front."""
    N, C = feat.shape
    ppp = max(points_per_pixel, 1)
    dev = offsets.device
    npix = offsets.numel() - 1
    used = (offsets[1:] - offsets[:-1]).clamp(max=ppp)
    pid = torch.repeat_interleave(torch.arange(npix, device=dev), used)
    start = torch.cumsum(used, 0) - used
    rank = torch.arange(pid.numel(), device=dev) - start[pid]
    n = order[offsets[:-1][pid] + rank] % N
    comp = rank < points_per_pixel
    ncomp = int(comp.sum())
    rows = torch.unique(n[comp]).numel()
    front = torch.unique(n[rank == 0]).numel()
    nbytes = (8 * pid.numel() + 4 * ncomp + 8 * (npix + 1) + 4 * front
              + 4 * C * rows + 4 * npix * (C + 2))
    return nbytes, [(float(ncomp) * (2 * C + 6), F32_FLOPS_PER_S)]


# reference module attribute -> (the program's kernel it stands for, its arithmetic)
WORK = {
    ("models.stereo.hitnet", "tile_warp_cost"): ("tile_warp_cost", tile_warp_cost),
    ("ops.corr", "corr_lookup_levels"): ("corr_lookup", corr_lookup_levels),
    ("ops.gn", "gn_fused_solve"): ("gn_fused_solve", gn_fused_solve),
    ("ops.splat", "composite"): ("splat_composite", splat_composite),
}


class Work:
    """What one counted call needs: the model's FLOPs, and per hand kernel
    its launches, bound seconds and operations."""

    def __init__(self):
        self.flops = 0.0
        self.launches: Dict[str, int] = {}
        self.bound_s: Dict[str, float] = {}
        self.ops: Dict[str, float] = {}

    def add(self, kernel: str, nbytes: float, flops: List) -> None:
        self.launches[kernel] = self.launches.get(kernel, 0) + 1
        self.bound_s[kernel] = self.bound_s.get(kernel, 0.0) + bound_s(nbytes, flops)
        self.ops[kernel] = self.ops.get(kernel, 0.0) + sum(f for f, _ in flops)

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "launches": dict(self.launches),
                "bound_s": dict(self.bound_s), "ops": dict(self.ops)}


@contextlib.contextmanager
def counted_work(ref_pkg: str):
    """Within the block the reference's hand-kernel ops are counted into the
    yielded ``Work``, and every FLOP outside them by the flop counter; on
    exit ``work.flops`` holds the call's total (the ops' own counts
    included, their plain forms' left out)."""
    import importlib
    from torch.utils.flop_counter import FlopCounterMode

    work = Work()
    counter = FlopCounterMode(display=False)
    inner = [0.0]
    depth = [0]   # an op that calls itself (an autograd Function's forward) counts once
    saved = []
    for (mod_name, attr), (kernel, arith) in WORK.items():
        mod = importlib.import_module(f"{ref_pkg}.{mod_name}")
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def wrapped(*args, _fn=fn, _kernel=kernel, _arith=arith, **kwargs):
            if depth[0]:
                return _fn(*args, **kwargs)
            nbytes, flops = _arith(*args, **kwargs)
            work.add(_kernel, nbytes, flops)
            before = counter.get_total_flops()
            depth[0] += 1
            try:
                out = _fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            inner[0] += counter.get_total_flops() - before
            return out

        setattr(mod, attr, wrapped)
    try:
        with counter:
            yield work
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    work.flops = counter.get_total_flops() - inner[0] + sum(work.ops.values())
    if not math.isfinite(work.flops):
        raise RuntimeError("counted_work: non-finite FLOP count")
