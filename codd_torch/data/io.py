"""Format codecs for the supported datasets (host-side, numpy; the port's
own copy of ``codd_tpu/data/io.py``).

KITTI's 16-bit PNGs go through ``read_png``, a decoder in numpy and the
standard library's ``zlib``: imageio's PIL backend decodes a 16-bit RGB
PNG (KITTI flow) to 8 bits.  It covers what ``codd_tpu``'s native decoder
covers (non-interlaced; 8 or 16 bits; gray, gray+alpha, RGB, RGBA; the
five filter types).  Other PNGs are read through ``imageio``, imported
inside the reader: a machine that only streams tensors through the model
need not have it.

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
import struct
import zlib
from typing import Tuple

import numpy as np

_FLO_MAGIC = 202021.25

__all__ = [
    "imread", "read_png", "read_pfm", "write_pfm", "read_flo", "write_flo",
    "read_sintel_disparity", "read_sintel_segmentation",
    "read_kitti_disparity", "read_kitti_flow", "read_tartanair_npy",
]


def imread(path) -> np.ndarray:
    """PNG (or any imageio format) -> array of raw samples.  A PNG whose
    IHDR says 16-bit colour (RGB or RGBA) goes through ``read_png``:
    imageio drops its low bytes.  The rest goes through imageio, which
    reads them right and faster (``read_png`` runs Average and Paeth rows
    byte by byte)."""
    if _is_png_16bit_colour(path):
        return read_png(path)
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(path))


def _is_png_16bit_colour(path) -> bool:
    """The signature, then IHDR's bit depth 16 and a colour type with the
    colour bit (2 RGB, 6 RGBA)."""
    try:
        with open(path, "rb") as f:
            head = f.read(26)
    except (OSError, TypeError):
        return False
    return (len(head) == 26 and head[:8] == _PNG_SIGNATURE
            and head[12:16] == b"IHDR" and head[24] == 16
            and head[25] in (2, 6))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples a pixel


def _unfilter_sequential(kind, raw, up, bpp):
    """Average (3) or Paeth (4) filter of one row: each byte depends on the
    reconstructed byte ``bpp`` to its left, so this runs byte by byte."""
    cur = bytearray(raw)
    n = len(cur)
    if kind == 3:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 255
        return cur
    for i in range(min(bpp, n)):          # a = c = 0: the predictor is b
        cur[i] = (cur[i] + up[i]) & 255
    for i in range(bpp, n):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return cur


def read_png(path: str) -> np.ndarray:
    """PNG -> (H, W) for gray, else (H, W, C) raw samples, uint8 or uint16
    (16-bit samples are big-endian in the file).  Raises ``ValueError`` on
    what it does not cover: palette, interlaced, 1/2/4-bit."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if interlace or depth not in (8, 16) or color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"color type {color}, interlace {interlace})")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8                    # bytes a pixel
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG data")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    px = np.empty((height, stride), np.uint8)
    up = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            px[y] = line
        elif kind == 1:   # Sub: a running sum mod 256 along each byte lane
            px[y] = np.cumsum(line.reshape(width, bpp), 0,
                              dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            px[y] = line + up
        elif kind in (3, 4):
            px[y] = np.frombuffer(_unfilter_sequential(
                kind, line.tobytes(), up.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: bad PNG filter type {kind} in row {y}")
        up = px[y]
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    img = px.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


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
    return read_png(path).squeeze().astype(np.float32) / 256.0


def read_kitti_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """16-bit RGB PNG -> (flow (H,W,2), valid (H,W))."""
    img = read_png(path).astype(np.float32)
    flow = (img[..., :2] - 2 ** 15) / 64.0
    valid = img[..., 2]
    return flow, valid


def read_tartanair_npy(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)
