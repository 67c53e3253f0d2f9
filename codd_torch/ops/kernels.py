"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source is an ``sm_90a`` translation unit with plain C launch
functions that return their ``cudaError_t`` (``tile_warp.cu``,
``gn_window.cu``, ``splat_composite.cu`` and ``corr_patch.cu`` hold the
forward and the backward, ``corr_patch.cu`` also the coordinates'
gradient); sources may share code through
the headers in ``csrc/*.cuh``.  ``load()`` compiles every source with its
own ``nvcc`` process, all started together, into
``<repo>/build/kernels/<name>-<content hash>.so`` and opens each library with
``ctypes``; the hash covers the source and every header, so a library is
reused only while both are unchanged.  Nothing is built
or imported when this module is imported: the first CUDA launch builds.

Launch counts: ``launch()`` adds one to a kernel's count each time it
launches it, and nothing else does, so a run can show that the main path
went through the kernels (``reset_counts()`` before, ``counts()`` after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["KERNELS", "load", "counts", "reset_counts", "launch",
           "stream_ptr", "check_cuda", "check_forward_only"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"

# kernel name -> (source file, C entry point, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "tile_warp_cost": ("tile_warp.cu", "tile_warp_cost_launch",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "tile_warp_cost_backward": ("tile_warp.cu",
                                "tile_warp_cost_backward_launch",
                                [_P] * 7 + [_I] * 6 + [_P]),
    "corr_lookup": ("corr_lookup.cu", "corr_lookup_launch",
                    [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P]),
    "gn_fused_solve": ("gn_fused.cu", "gn_fused_solve_launch",
                       [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P]),
    "splat_composite": ("splat_composite.cu", "splat_composite_launch",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _P]),
    "gn_window_aggregate": ("gn_window.cu", "gn_window_aggregate_launch",
                            [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "corr_patch_lookup": ("corr_patch.cu", "corr_patch_lookup_launch",
                          [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P]),
    "gn_window_aggregate_backward": ("gn_window.cu",
                                     "gn_window_aggregate_backward_launch",
                                     [_P] * 5 + [_I] * 4 + [_P]),
    "corr_patch_lookup_backward": ("corr_patch.cu",
                                   "corr_patch_lookup_backward_launch",
                                   [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5
                                   + [_P]),
    "corr_patch_lookup_coords_backward": (
        "corr_patch.cu", "corr_patch_lookup_coords_backward_launch",
        [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5 + [_P]),
    "splat_composite_backward": ("splat_composite.cu",
                                 "splat_composite_backward_launch",
                                 [_P] * 10 + [_I] * 5 + [_P]),
}

_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on first use and need the CUDA toolkit")
    return found


def _lib_path(src: Path) -> Path:
    """Library path keyed by the source and every shared header."""
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    return BUILD / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def load(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and open every kernel library; idempotent."""
    with _LOCK:
        if len(_LIBS) == len(KERNELS):
            return _LIBS
        BUILD.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sorted({src for src, _, _ in KERNELS.values()}):
            out = _lib_path(CSRC / src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", str(tmp), str(CSRC / src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            jobs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
            if verbose and log.strip():
                print(f"[nvcc {name}]\n{log.strip()}")
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(errors))
        opened: Dict[str, ctypes.CDLL] = {}
        for name, (src, fn, argtypes) in KERNELS.items():
            if src not in opened:
                opened[src] = ctypes.CDLL(str(_lib_path(CSRC / src)))
            lib = opened[src]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C launcher, count it, raise on a launch error."""
    _, fn, _ = KERNELS[name]
    err = getattr(load()[name], fn)(*args)
    _LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda(name: str, *tensors, dtypes=None) -> None:
    """Wrapper-side checks shared by the kernels: CUDA, contiguous, dtype."""
    for i, t in enumerate(tensors):
        if not t.is_cuda:
            raise ValueError(f"{name}: argument {i} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: argument {i} has dtype {t.dtype}, "
                            f"expected {dtypes[i]}")


def check_forward_only(name: str, *tensors) -> None:
    """A kernel without a backward raises where autograd would need its
    gradient, rather than return a tensor cut from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only (no backward yet); "
            "call it under torch.no_grad() or on tensors that need no "
            "gradient")
