"""Format codecs for the supported datasets (host-side, numpy; the port's
own copy of ``codd_tpu/data/io.py`` without the native C++ decoder).

PNGs are read through ``imageio``, imported inside the reader: nothing
else in this package needs it, and a machine that only streams tensors
through the model need not have it.

Formats:
  * PFM (SceneFlow/FlyingThings3D disparities)
  * Middlebury .flo optical flow (Sintel)
  * Sintel 3-channel disparity PNG (r*4 + g/64 + b/16384)
  * Sintel segmentation PNG ((r*256+g)*256+b)
  * KITTI 16-bit disparity PNG (value/256)
  * KITTI 16-bit flow PNG ((rg - 2^15)/64, b = valid)
  * TartanAir .npy (depth / flow / mask arrays)
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

_FLO_MAGIC = 202021.25

__all__ = [
    "imread", "read_pfm", "write_pfm", "read_flo", "write_flo",
    "read_sintel_disparity", "read_sintel_segmentation",
    "read_kitti_disparity", "read_kitti_flow", "read_tartanair_npy",
]


def imread(path) -> np.ndarray:
    """PNG (or any imageio format) -> array of raw samples."""
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(path))


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Returns (data flipped to top-down, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode("ascii")
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM dims: {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("ascii").strip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), dtype=endian + "f4")
        shape = (h, w, 3) if channels == 3 else (h, w)
        return np.flipud(data.reshape(shape)).copy(), abs(scale)


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0):
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        np.flipud(data).astype("<f4").tofile(f)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"bad .flo magic in {path}: {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray):
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_sintel_disparity(path: str) -> np.ndarray:
    """3-channel uint8 PNG -> disparity in [0, 1024)."""
    img = imread(path).astype(np.float64)
    return (img[..., 0] * 4 + img[..., 1] / 64.0 + img[..., 2] / 16384.0)


def read_sintel_segmentation(path: str) -> np.ndarray:
    img = imread(path).astype(np.int32)
    return (img[..., 0] * 256 + img[..., 1]) * 256 + img[..., 2]


def read_kitti_disparity(path: str) -> np.ndarray:
    """16-bit PNG; disparity = value / 256 (0 = invalid)."""
    return imread(path).squeeze().astype(np.float32) / 256.0


def read_kitti_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """16-bit RGB PNG -> (flow (H,W,2), valid (H,W)).  imageio's PIL
    backend decodes 16-bit RGB to 8 bits; that would be wrong flow, so it
    raises instead."""
    img = imread(path)
    if img.dtype != np.uint16:
        raise ValueError(
            f"{path}: decoded as {img.dtype}, not 16-bit; this imageio "
            "backend cannot read 16-bit RGB PNGs (KITTI flow)")
    img = img.astype(np.float32)
    flow = (img[..., :2] - 2 ** 15) / 64.0
    valid = img[..., 2]
    return flow, valid


def read_tartanair_npy(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)
