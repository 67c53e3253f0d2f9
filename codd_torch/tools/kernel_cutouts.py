"""Cut-out timings of a hand-written kernel on a CUDA card.

    python -m codd_torch.tools.kernel_cutouts [--kernel NAME[,NAME...]]
        [--source PATH] [--cutouts a,b] [--forward-only] [--box-bytes N]

Builds copies of a kernel's source, each with one named part cut out or
made trivial, side by side with nvcc (into ``build/cutouts/<kernel>/``),
and times each copy's launcher on chip_smoke.py phase 3's call with CUDA
events, in turns.  What a cut-out saves ranks the costs of a kernel where
no profiler with pipe counters runs.  The copies compute wrong results and
are never loaded by the port.  Kernels (``--kernel``, default
``tile_warp``):

- ``tile_warp``: kernel 1 and its backward 1b (``csrc/tile_warp.cu``) at
  384x1280, C=16: a random field, and for the backward also a smooth one,
  in f32 and bf16, and 1b in bf16 at the training call (4 x 384x768);
  ``--forward-only`` skips the backward, whose launcher an older revision
  may not share;
- ``corr_coords``: the lookup's coordinate gradient 6c
  (``csrc/corr_patch.cu``) at the motion stage's training call, B=4, 48x96
  queries, four levels, on the smooth and the scattered field, with the
  box budget ``--box-bytes`` (the wrapper's ``PATCH_COORDS_BOX_BYTES`` by
  default; the first form took ``PATCH_BOX_BYTES``, 98304);
- ``splat_backward``: the splat's backward 4b (``csrc/splat_composite.cu``)
  at the joint stage's two calls, full res 384x768 C=6 r=1 and quarter res
  96x192 C=32 r=2.

``--source`` times another revision: the kernel's file, or a directory
holding it (for example the parent commit's ``codd_torch/csrc`` unpacked
under ``build/``; its headers are taken from there too).  A cut-out whose
part the revision does not have is skipped.  Prints one line per call,
each copy's ms on each turn, the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import corr, kernels, se3, splat, tile_warp
from ..ops.projective import inv_project

H, W, C = 384, 1280, 16
OUT = kernels.BUILD.parent / "cutouts"


def _cut(start: str, end: str, new: str = ""):
    """Replace the text from ``start`` up to (not including) ``end``."""
    def edit(src: str) -> str:
        if start not in src:
            raise ValueError("marker not found")
        a = src.index(start)
        return src[:a] + new + src[src.index(end, a):]
    return edit


def _swap(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError("marker not found")
        return src.replace(old, new)
    return edit


def _all(*edits):
    """Every edit in turn (a ValueError from any: the part is missing)."""
    def edit(src: str) -> str:
        for e in edits:
            src = e(src)
        return src
    return edit


def _first(*edits):
    """The first edit whose part the revision has (one per revision)."""
    def edit(src: str) -> str:
        for e in edits:
            try:
                return e(src)
            except ValueError:
                pass
        raise ValueError("marker not found")
    return edit


TILE_WARP_CUTOUTS = {
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

# 6c: the first edit of each pair cuts PR 12's form (a block every level
# of a tile, lookup_tile<R, true>), the second the current one's (a block a
# tile and level, marked CUTOUT)
CORR_COORDS_CUTOUTS = {
    "as_is": lambda src: src,
    # the box's copies and the wait for them (the taps read stale shared
    # memory); the plan stays, the dots and the epilogue need it
    "no_staging": _first(
        _all(_swap("        if (staged) mbar_expect(smem_u32(&bar), "
                   "(unsigned)(bw * bh * PIX_BYTES));\n", ""),
             _swap("    if (staged) mbar_wait(smem_u32(&bar), phase++ & 1);",
                   ""),
             _cut("      if (staged) {\n        for (int row = lane;",
                  "    }\n    __syncthreads();\n    const bool staged")),
        _cut("  // CUTOUT stage {", "  // CUTOUT stage }")),
    # the tap dots (each query's taps made from its f1 row)
    "no_dots": _first(
        _cut("          if (staged) {\n            const long long stride"
             " = plan[2];",
             "        } else {\n          // the whole window lies outside",
             "          dots[lane] = a[lane];\n"
             "          dots[lane + 32] = a[lane + 32];\n"),
        _cut("  // CUTOUT dots {", "  // CUTOUT dots }")),
    # the epilogue over g: each query's 49 outputs against the bilinear
    # weights' derivatives (its first two dots stand in)
    "no_epilogue": _first(
        _cut("          float px = 0.f, py = 0.f;",
             "#pragma unroll\n          for (int m = 16; m > 0; m >>= 1) {",
             "          float px = dots[lane], py = dots[lane + 32];\n"),
        _cut("    // CUTOUT epilogue {", "    // CUTOUT epilogue }",
             "      px = dots[l];\n      py = dots[l + 32];\n")),
    # level 0 alone (every other level's work skipped)
    "one_level": _first(
        _swap("lvl1 = COORDS ? lv.n : lvl0 + 1", "lvl1 = COORDS ? 1 : lvl0 + 1"),
        _swap("warp = tid >> 5;\n  const int lvl = blockIdx.y;",
              "warp = tid >> 5;\n  const int lvl = blockIdx.y;\n"
              "  if (lvl > 0) return;")),
}

# the points pass's row gather in the form of 4 channels a thread (PR 12's
# only form; the form for C > WALK_C since)
_GATHER4 = _cut("      float gv[4];", "#pragma unroll\n      for (int j = 0; j < 4;"
                " ++j)\n        acc[j] = __fadd_rn",
                "      float gv[4] = {w, w + 1.f, w + 2.f, w + 3.f};\n")

# 4b: PR 12's runs pass (8 lanes a pixel; the form for C <= WALK_C since)
_DOT8 = _swap("    dot = row_dot(g + (long long)p * C, feat + fo, C);",
              "    dot = a * (float)fo;")
_SCANS8 = _all(_cut("  float excl = 0.f;\n#pragma unroll",
                    "  const float T = expf(excl);", "  float excl = la;\n"),
               _cut("  float after = 0.f;\n#pragma unroll",
                    "  if (mine) {\n", "  float after = wd;\n"))

_RUN_WRITES8 = _swap("  if (mine) {\n    dalpha[o] = __fsub_rn(",
                     "  if (mine && dot == 12345.f) {\n    dalpha[o] = "
                     "__fsub_rn(")

# 4b: the first edit cuts the part in both runs passes where the revision
# has the lanes form (marked CUTOUT), the second PR 12's alone
SPLAT_BACKWARD_CUTOUTS = {
    "as_is": lambda src: src,
    # the runs pass alone, the points pass alone
    "runs_only": _first(
        _swap("  if (N > 0) {\n    const int groups", "  if (N < 0) {\n"
              "    const int groups"),
        _swap("  if (N > 0) {  // CUTOUT points", "  if (N < 0) {")),
    "points_only": _first(
        _swap("  if (npix > 0) {\n    const long long threads = (long long)"
              "npix * BLANES;", "  if (npix < 0) {\n    const long long "
              "threads = (long long)npix * BLANES;"),
        _swap("  if (npix > 0) {  // CUTOUT runs", "  if (npix < 0) {")),
    # the runs pass's dot g . f (a value made from the fragment id)
    "no_dot": _first(_all(_DOT8, _cut("  // CUTOUT lanes dot {",
                                      "  // CUTOUT lanes dot }",
                                      "  dot = a * (float)o;\n")), _DOT8),
    # the runs pass's two scans along the run (each value its own)
    "no_scans": _first(
        _all(_SCANS8, _cut("  // CUTOUT scan1 {", "  // CUTOUT scan1 }",
                           "  excl = la;\n"),
             _cut("  // CUTOUT scan2 {", "  // CUTOUT scan2 }",
                  "  after = wd;\n")),
        _SCANS8),
    # the runs pass's writes of dalpha and frag (kept where a dot is 12345,
    # which none is)
    "no_run_writes": _first(
        _all(_RUN_WRITES8, _swap("  if (mine && j == 0)\n", "  if (mine && j =="
                                 " 0 && dot == 12345.f)\n")),
        _RUN_WRITES8),
    # the points pass's gathers of g (values made from the weight)
    "no_gather_g": _GATHER4,
}


def corr_fields(noise, h8, w8, dev):
    """The lookups' two coordinate fields at 1/8 resolution: "scattered",
    the grid plus ``noise`` (i.i.d. N(0, 6^2) px), and "smooth", the grid
    plus a bilinearly upsampled (6, 20) field of +-8 px plus 0.25 px of
    jitter, seeded on its own (coherent, as the main path's targets are)."""
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


def _gen():
    return torch.Generator(device="cpu").manual_seed(0)


def tile_warp_calls(lib, dev, opts):
    """label -> (launcher, args): kernel 1 in each form, seeded as
    chip_smoke.py phase 3 draws its inputs; 1b on the random and a smooth
    field."""
    g = _gen()
    fl, fr = (torch.randn(1, H, W, C, generator=g).to(dev) for _ in range(2))
    hyp3 = torch.stack([torch.rand(1, H // 4, W // 4, generator=g) * 320.0,
                        torch.rand(1, H // 4, W // 4, generator=g) * 2 - 1,
                        torch.rand(1, H // 4, W // 4, generator=g) * 2 - 1],
                       -1).to(dev)
    gout = torch.randn(1, H // 4, W // 4, 48, generator=g).to(dev)
    smooth = torch.zeros_like(hyp3)
    smooth[..., 0] = 20.3
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for form, code in tile_warp.FORMS.items():
        ins = [hyp3, fl, fr]
        if form != "f32":
            ins = [t.to(torch.bfloat16) for t in ins]
        res = torch.empty((1, H // 4, W // 4, 48), dtype=ins[2].dtype,
                          device=dev)
        args = [t.data_ptr() for t in ins] + [res.data_ptr(), 1, H, W, C,
                                              code, stream]
        out[f"forward {form}"] = (lib.tile_warp_cost_launch, args, ins + [res])
    if not opts.forward_only:
        cg = tile_warp.backward_channel_group(W, C)
        for form in ("f32", "exact"):
            dt = torch.float32 if form == "f32" else torch.bfloat16
            for label, h in (("random", hyp3), ("smooth", smooth)):
                ins = [t.to(dt) for t in (h, fl, fr, gout)]
                ts = ins + [torch.empty_like(t) for t in ins[:3]]
                args = [t.data_ptr() for t in ts] + [
                    1, H, W, C, cg, tile_warp.FORMS[form], stream]
                name = label if form == "f32" else f"bf16 {label}"
                out[f"backward {name}"] = (
                    lib.tile_warp_cost_backward_launch, args, ts)
        g, hyp, fa, fb = training_call_inputs(dev)
        B, h, w, _ = fa.shape
        ts = [hyp, fa, fb, g] + [torch.empty_like(t) for t in (hyp, fa, fb)]
        args = [t.data_ptr() for t in ts] + [
            B, h, w, C, tile_warp.backward_channel_group(w, C),
            tile_warp.FORMS["exact"], stream]
        out["backward bf16 training call"] = (
            lib.tile_warp_cost_backward_launch, args, ts)
    return out


def training_call_inputs(dev):
    """1b's bf16 inputs (g, hyp3, fea_l, fea_r) at the training call, 4 x
    384x768, C=16, drawn as tests/test_torch_gpu.py draws its random field
    (seed 0; disparities -20 to W + 20: taps past both edges)."""
    B, h, w = 4, 384, 768
    g = _gen()
    fl, fr = (torch.randn(B, h, w, C, generator=g) for _ in range(2))
    hyp3 = torch.stack([torch.rand(B, h // 4, w // 4, generator=g)
                        * (w + 40) - 20,
                        torch.rand(B, h // 4, w // 4, generator=g) * 4 - 2,
                        torch.rand(B, h // 4, w // 4, generator=g) * 4 - 2],
                       -1)
    gout = torch.randn(B, h // 4, w // 4, 48, generator=g)
    return [t.to(dev).to(torch.bfloat16) for t in (gout, hyp3, fl, fr)]


def corr_coords_calls(lib, dev, opts):
    """6c at the motion stage's training call (B=4, 48x96 queries, four
    padded levels of 128 bf16 channels), as chip_smoke.py phase 3 builds
    it: random features and cotangents, the two coordinate fields; the
    launcher's budget ``--box-bytes``."""
    g = _gen()
    B, h, w = 4, 48, 96
    f1, f2 = (torch.randn(B, h, w, 128, generator=g).to(dev)
              for _ in range(2))
    pyr = corr.build_corr_pyramid(f1, f2, 4, 3, impl="patch")
    gl = torch.randn(B, h, w, 4 * 49, generator=g).to(dev)
    fields = corr_fields(
        torch.randn(1, h, w, 2, generator=g).to(dev) * 6.0, h, w, dev)
    levels = pyr["levels"]
    ptrs, hw, sc = corr._levels_args(levels, [l.shape[1:3] for l in levels],
                                     corr._scales(len(levels), None))
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    part = torch.empty((len(levels), B * h * w, 2), device=dev)
    for label, c in fields.items():
        c = torch.cat([c] * B).contiguous()
        dc = torch.empty((B, h, w, 2), dtype=torch.float32, device=dev)
        args = [pyr["f1"].data_ptr(), ptrs, hw, sc, len(levels), c.data_ptr(),
                gl.data_ptr(), dc.data_ptr()] + (
                    [] if lib.old_form else [part.data_ptr()]) + [
                B, h, w, 3, opts.box_bytes, stream]
        out[label] = (lib.corr_patch_lookup_coords_backward_launch, args,
                      [pyr["f1"], *levels, c, gl, dc, part])
    return out


def splat_backward_calls(lib, dev, opts):
    """4b at the joint stage's two splat calls (one image of B=4), built as
    chip_smoke.py phase 3 builds them: seeded depths and twists through
    SceneFlow's intrinsics, random features and cotangents."""
    g = _gen()

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(dev)

    Ht, Wt = 384, 768
    intr = torch.tensor([[1050.0, 1050.0, 480.0, 270.0]], device=dev)
    depth = (torch.rand((1, Ht, Wt), generator=g) * 58.0 + 2.0).to(dev)
    Ts = se3.exp(randn(1, Ht, Wt, 6, scale=0.01))
    X = se3.act(Ts, inv_project(depth, intr)).reshape(-1, 3)
    Xq = se3.act(Ts[:, 1::4, 1::4], inv_project(depth[:, 1::4, 1::4],
                                                intr / 4)).reshape(-1, 3)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, pts, k, hh, ww, r, c in (
            ("full res 384x768 C=6", X, intr[0], Ht, Wt, 1.0, 6),
            ("quarter res 96x192 C=32", Xq, intr[0] / 4, Ht // 4, Wt // 4,
             2.0, 32)):
        order, offsets, alpha, _ = splat.sort_fragments(pts, k, hh, ww, r)
        N, M, npix = pts.shape[0], order.numel(), hh * ww
        feat, gg, gz = randn(N, c), randn(npix, c), randn(npix)
        # zeros: a cut-out without the runs pass still reads valid pixels
        frag = torch.zeros((M, 4), dtype=torch.int32, device=dev)
        dfeat, dalpha, dz = (torch.empty(s, device=dev)
                             for s in ((N, c), (M,), (N,)))
        ts = [order, offsets, alpha, feat, gg, gz, frag, dfeat, dalpha, dz]
        args = [t.data_ptr() for t in ts] + [npix, N, c, M // N, 8, stream]
        out[label] = (lib.splat_composite_backward_launch, args, ts)
    return out


# launchers whose parameters an older revision lacks: the marker of the
# current form in the source, and the older argtypes (6c before its
# scratch of level gradients)
_OLD_ARGTYPES = {"corr_patch_lookup_coords_backward": (
    "void* dcoords, void* part,",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p])}

# --kernel -> (source file, its cut-outs, the C entry points it times, the
# calls)
TARGETS = {
    "tile_warp": ("tile_warp.cu", TILE_WARP_CUTOUTS,
                  ("tile_warp_cost", "tile_warp_cost_backward"),
                  tile_warp_calls),
    "corr_coords": ("corr_patch.cu", CORR_COORDS_CUTOUTS,
                    ("corr_patch_lookup_coords_backward",), corr_coords_calls),
    "splat_backward": ("splat_composite.cu", SPLAT_BACKWARD_CUTOUTS,
                       ("splat_composite_backward",), splat_backward_calls),
}


def build(kernel: str, source: Path, names):
    """Compile each cut-out of ``source`` in parallel -> {name: CDLL}."""
    _, cutouts, entries, _ = TARGETS[kernel]
    out = OUT / kernel
    out.mkdir(parents=True, exist_ok=True)
    text, jobs = source.read_text(), {}
    for name in names:
        try:
            cut = cutouts[name](text)
        except ValueError:
            print(f"  {kernel} {name}: not in {source}, skipped")
            continue
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        if so.exists() and cu.exists() and cu.read_text() == cut:
            jobs[name] = (so, None)  # built from this text already
            continue
        cu.write_text(cut)
        jobs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-I", str(source.parent), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate() if proc else ("", None)
        if proc and proc.returncode != 0:
            so.unlink(missing_ok=True)
            raise RuntimeError(f"cut-out {kernel} {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        for entry in entries:
            _, fn, argtypes = kernels.KERNELS[entry]
            marker, old = _OLD_ARGTYPES.get(entry, ("", None))
            libs[name].old_form = marker not in text
            getattr(libs[name], fn).argtypes = (old if libs[name].old_form
                                                else argtypes)
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


def run(kernel: str, source: Path, names, opts, dev):
    """Each cut-out's ms on each call, two turns -> {label: {name: [ms]}}."""
    if source.is_dir():
        source = source / TARGETS[kernel][0]
    libs = build(kernel, source, names)
    table = {}
    for _ in range(2):  # in turns, twice
        for name, lib in libs.items():
            for label, (fn, a, _) in TARGETS[kernel][3](
                    lib, dev, opts).items():
                def launch(fn=fn, a=a):
                    err = fn(*a)
                    if err:
                        raise RuntimeError(f"{kernel} {name} {label}: error "
                                           f"{err}")
                table.setdefault(label, {}).setdefault(name, []).append(
                    device_ms(launch))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="tile_warp",
                    help="comma list of " + ", ".join(TARGETS))
    ap.add_argument("--source", type=Path, default=kernels.CSRC,
                    help="the kernel's source file, or a directory holding "
                         "it (default codd_torch/csrc)")
    ap.add_argument("--forward-only", action="store_true",
                    help="tile_warp: the forward alone")
    ap.add_argument("--box-bytes", type=int,
                    default=corr.PATCH_COORDS_BOX_BYTES,
                    help="corr_coords: the launcher's box budget (default "
                         "the wrapper's; 98304 for the parent revision's)")
    ap.add_argument("--cutouts", default=None,
                    help="comma list (default: every cut-out of the kernel)")
    args = ap.parse_args(argv)
    targets = args.kernel.split(",")
    for k in targets:
        if k not in TARGETS:
            ap.error(f"unknown kernel {k!r}; one of {', '.join(TARGETS)}")
    if not torch.cuda.is_available():
        print("kernel_cutouts: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for k in targets:
        names = (args.cutouts.split(",") if args.cutouts
                 else list(TARGETS[k][1]))
        for label, row in run(k, args.source, names, args, dev).items():
            print(f"{k} {label}: " + "  ".join(
                f"{n} " + "/".join(f"{t:.4f}" for t in ts)
                for n, ts in row.items()) + " ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
