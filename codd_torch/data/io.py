"""Format codecs for the supported datasets (host-side, numpy; the port's
own copy of ``codd_tpu/data/io.py``).

Every PNG goes through the port's native decoder
(``codd_torch/data/native.py``): Python's ``zlib`` inflates, a small C++
library built by g++ on first use reconstructs the filtered rows.  It
covers non-interlaced PNGs of 8 or 16 bits, gray, gray+alpha, RGB and
RGBA, with the five filter types, and raises on the rest; 16-bit samples
keep all their bits (KITTI's flow and disparity).  ``read_png`` is the
same decoder in numpy, its plain version: Average and Paeth rows run byte
by byte in Python there, so it is slow on large files and nothing on a
data path calls it.  Files that are not PNGs go through ``imageio``,
imported inside ``imread``.  ``write_png`` encodes with ``zlib`` alone,
its rows cycling through the filter types.

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
    "imread", "read_png", "write_png", "png_rows", "png_samples",
    "read_pfm", "write_pfm", "read_flo", "write_flo",
    "read_sintel_disparity", "read_sintel_segmentation",
    "read_kitti_disparity", "read_kitti_flow", "read_tartanair_npy",
]


def imread(path) -> np.ndarray:
    """Image file -> array of raw samples: (H, W) for gray, else (H, W,
    C), uint8 or uint16.  A PNG goes through the native decoder
    (``native.decode``), whatever its depth and channels, with no
    fallback; another format through imageio."""
    if _is_png(path):
        from .native import decode
        return decode(path)
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(path))


def _is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _PNG_SIGNATURE


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


def png_rows(path: str):
    """Parse a PNG's chunks and inflate its image data: returns
    ``(rows, height, width, depth, channels)``, ``rows`` the filtered rows
    as a (height, 1 + stride) uint8 array, a row's filter type first.
    Raises ``ValueError`` on what the decoders do not cover: palette,
    interlaced, 1/2/4-bit."""
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
    stride = width * channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG data")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    return rows, height, width, depth, channels


def png_samples(px: np.ndarray, height: int, width: int, depth: int,
                channels: int) -> np.ndarray:
    """Reconstructed (height, stride) bytes -> the image's samples (16-bit
    samples are big-endian in the file)."""
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    img = px.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    """PNG -> (H, W) for gray, else (H, W, C) raw samples, uint8 or uint16:
    the plain version of ``native.decode``, in numpy (see the module
    docstring)."""
    rows, height, width, depth, channels = png_rows(path)
    stride = rows.shape[1] - 1
    bpp = channels * depth // 8                    # bytes a pixel
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
    return png_samples(px, height, width, depth, channels)


def write_png(path: str, img: np.ndarray, filters=(0, 1, 2, 3, 4),
              idat_chunks: int = 1) -> None:
    """(H, W) or (H, W, C) uint8 / uint16 samples (C = 1-4) -> a PNG whose
    rows take the filter types ``filters`` in turn, as an adaptive
    encoder's output mixes them; deflated by ``zlib`` and split into
    ``idat_chunks`` IDAT chunks, as encoders may split it."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    px = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8
                              ).view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = c * depth // 8
    lead = np.zeros(bpp, np.int32)
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        x, up = px[y], (px[y - 1] if y else np.zeros_like(px[0]))
        a = np.concatenate([lead, x[:-bpp]])
        ul = np.concatenate([lead, up[:-bpp]])
        if kind == 4:
            pa, pb = np.abs(up - ul), np.abs(a - ul)
            pc = np.abs(a + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, ul))
        else:
            pred = (0 * x, a, up, (a + up) >> 1)[kind]
        rows.append(bytes([kind])
                    + ((x - pred) & 255).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = zlib.compress(b"".join(rows))
    cuts = np.linspace(0, len(raw), idat_chunks + 1).astype(int)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                             0, 0, 0))
                + b"".join(chunk(b"IDAT", raw[a:b])
                           for a, b in zip(cuts[:-1], cuts[1:]))
                + chunk(b"IEND", b""))


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
    """16-bit RGB PNG -> (flow (H,W,2), valid (H,W))."""
    img = imread(path).astype(np.float32)
    flow = (img[..., :2] - 2 ** 15) / 64.0
    valid = img[..., 2]
    return flow, valid


def read_tartanair_npy(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)
