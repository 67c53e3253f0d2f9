"""The port's native PNG decoder (counterpart of ``codd_tpu/data/native.py``,
PNG only).

``decode`` parses a PNG's chunks and inflates its image data with
Python's ``zlib`` (``io.png_rows``), then reconstructs the filtered rows
in ``codd_torch/csrc/png_codec.cpp``, a plain C library that links
nothing.  g++ builds it on first use into
``<repo>/build/native/png_codec-<source hash>.so``; a failed build raises
with g++'s log, and nothing falls back to ``io.read_png`` (the plain
version, byte by byte in Python) or to imageio.  ``decode_batch`` decodes
many files on a thread pool: the inflate of a large buffer and the ctypes
call both release the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence

import numpy as np

from . import io as dio

__all__ = ["load_library", "decode", "decode_batch", "SOURCE", "BUILD"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "png_codec.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None
_lock = threading.Lock()


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"{src.stem}-{digest}.so"


def build(src: Path, out: Path) -> Path:
    """Compile ``src`` into the shared library ``out`` with g++; raises
    ``RuntimeError`` with g++'s output when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
           str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"PNG codec build failed: {' '.join(cmd)}: {e}"
                           ) from e
    if proc.returncode != 0:
        raise RuntimeError(f"PNG codec build failed (g++ exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once per source) and open the codec library."""
    global _lib
    with _lock:
        if _lib is None:
            out = _lib_path(SOURCE)
            if not out.exists():
                build(SOURCE, out)
            lib = ctypes.CDLL(str(out))
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
        return _lib


def decode(path: str) -> np.ndarray:
    """PNG -> (H, W) for gray, else (H, W, C) raw samples, uint8 or uint16;
    the bytes of ``io.read_png``'s result."""
    lib = load_library()
    rows, height, width, depth, channels = dio.png_rows(path)
    stride = rows.shape[1] - 1
    px = np.empty((height, stride), np.uint8)
    bad = lib.png_unfilter(rows.ctypes.data, px.ctypes.data, height, stride,
                           channels * depth // 8)
    if bad:
        raise ValueError(f"{path}: bad PNG filter type "
                         f"{int(rows[bad - 1, 0])} in row {bad - 1}")
    return dio.png_samples(px, height, width, depth, channels)


def decode_batch(paths: Sequence[str], num_threads: int = 4
                 ) -> List[np.ndarray]:
    """``decode`` of each path, ``num_threads`` files at a time."""
    load_library()
    with ThreadPoolExecutor(max(1, min(num_threads, len(paths)))) as pool:
        return list(pool.map(decode, paths))
