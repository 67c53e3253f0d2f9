"""Cut-out timings of kernel 1 (``csrc/tile_warp.cu``) on a CUDA card.

    python -m codd_torch.tools.kernel_cutouts [--source PATH] [--forward-only]

Builds copies of the source, each with one named part cut out or made
trivial, side by side with nvcc (into ``build/cutouts/``), and times each
copy's launchers on chip_smoke.py phase 3's call (384x1280, C=16, seeded
inputs: a random field, and for the backward also a smooth one) with CUDA
events, in turns.  What a cut-out saves ranks the costs of a kernel where
no profiler with pipe counters runs.  The copies compute wrong results and
are never loaded by the port.  ``--source`` times another revision of the
file (for example the parent commit's, unpacked under ``build/``);
``--forward-only`` skips the backward, whose launcher an older revision
may not share.  Prints one line per field and form, the card's name and
power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import kernels, tile_warp

H, W, C = 384, 1280, 16
OUT = kernels.BUILD.parent / "cutouts"


def _cut(start: str, end: str):
    def edit(src: str) -> str:
        a = src.index(start)
        return src[:a] + src[src.index(end, a):]
    return edit


def _swap(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError("marker not found")
        return src.replace(old, new)
    return edit


# name -> the edit of the source (ValueError: the revision has no such part)
CUTOUTS = {
    "as_is": lambda src: src,
    # every bf16 rounding of the exact form's f32 steps the identity
    "exact_no_rb": _swap("return __bfloat162float(__float2bfloat16_rn(v));",
                         "return v;"),
    # the backward's column gather (dfea_r left unwritten)
    "bwd_no_gather": _cut("    for (int t = tid; t < W * nk; t += nt) {",
                          "    __syncthreads();\n  }\n\n  // the tile's sums"),
    # the gather without decoding the signs
    "bwd_no_decode": _swap(
        "              if (ka >= 0) v -= signed_by(word >> (8 * ka + 2 * q),"
        " A);\n              if (kb <= 2) v -= signed_by(word >> (8 * kb + 2"
        " * q), Bv);",
        "              v -= A + Bv + (float)((word >> q) & 1u);"),
    # the backward's tap loads (values made from the left feature)
    "bwd_no_taps": _swap(
        "            load_ch4(row + (long long)(col0 + m) * C + c, tv[m]);",
        "            for (int q = 0; q < 4; ++q)\n"
        "              tv[m][q] = lv[q] * (float)(m + 1) + (float)col0;"),
    # the backward's dfea_l store
    "bwd_no_dfea_l": _swap(
        "        store_ch4(dfl + c, dl);",
        "        if (dl[0] == 12345.f)\n"
        "          store1(dfl + c, dl[1] + dl[2] + dl[3]);"),
}


def build(source: Path, names):
    """Compile each cut-out of ``source`` in parallel -> {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    text, jobs = source.read_text(), {}
    for name in names:
        try:
            cut = CUTOUTS[name](text)
        except ValueError:
            print(f"  {name}: not in {source}, skipped")
            continue
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(cut)
        jobs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"cut-out {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        for kernel in ("tile_warp_cost", "tile_warp_cost_backward"):
            _, fn, argtypes = kernels.KERNELS[kernel]
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def device_ms(fn, iters: int = 20) -> float:
    """Device ms a call: CUDA events around ``iters`` calls queued behind
    a spin kernel, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(dev):
    """Seeded as chip_smoke.py phase 3 draws kernel 1's inputs."""
    g = torch.Generator(device="cpu").manual_seed(0)
    fl, fr = (torch.randn(1, H, W, C, generator=g).to(dev) for _ in range(2))
    hyp3 = torch.stack([torch.rand(1, H // 4, W // 4, generator=g) * 320.0,
                        torch.rand(1, H // 4, W // 4, generator=g) * 2 - 1,
                        torch.rand(1, H // 4, W // 4, generator=g) * 2 - 1],
                       -1).to(dev)
    gout = torch.randn(1, H // 4, W // 4, 48, generator=g).to(dev)
    smooth = torch.zeros_like(hyp3)
    smooth[..., 0] = 20.3
    return hyp3, smooth, fl, fr, gout


def calls(lib, hyp3, smooth, fl, fr, gout, forward_only):
    """label -> a function that launches that part of ``lib`` once."""
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for form, code in tile_warp.FORMS.items():
        ins = [hyp3, fl, fr]
        if form != "f32":
            ins = [t.to(torch.bfloat16) for t in ins]
        res = torch.empty((1, H // 4, W // 4, 48), dtype=ins[2].dtype,
                          device=fl.device)
        args = [t.data_ptr() for t in ins] + [res.data_ptr(), 1, H, W, C,
                                              code, stream]
        out[f"forward {form}"] = (lib.tile_warp_cost_launch, args)
    if not forward_only:
        cg = tile_warp.backward_channel_group(W, C)
        grads = [torch.empty_like(t) for t in (hyp3, fl, fr)]
        for label, h in (("random", hyp3), ("smooth", smooth)):
            args = [t.data_ptr() for t in (h, fl, fr, gout, *grads)] + [
                1, H, W, C, cg, tile_warp.FORMS["f32"], stream]
            out[f"backward {label}"] = (lib.tile_warp_cost_backward_launch,
                                        args)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=kernels.CSRC / "tile_warp.cu")
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--cutouts", default=",".join(CUTOUTS),
                    help="comma list of " + ", ".join(CUTOUTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_cutouts: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build(args.source, args.cutouts.split(","))
    data = inputs(dev)
    table = {}
    for rep in range(2):  # in turns, twice
        for name, lib in libs.items():
            for label, (fn, a) in calls(lib, *data,
                                        args.forward_only).items():
                def launch(fn=fn, a=a):
                    err = fn(*a)
                    if err:
                        raise RuntimeError(f"{name} {label}: error {err}")
                table.setdefault(label, {}).setdefault(name, []).append(
                    device_ms(launch))
    for label, row in table.items():
        print(f"{label}: " + "  ".join(
            f"{n} " + "/".join(f"{t:.4f}" for t in ts)
            for n, ts in row.items()) + " ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
