"""Clip-consistent augmentations and formatting transforms (host-side
numpy; the port's own copy of ``codd_tpu/data/transforms.py``, equal in
bits to it under the same ``np.random.Generator``: the same draws in the
same order):

  * RandomCrop — one crop for the whole clip and every field; shifts the
    principal point (cx, cy) by the crop offset,
  * PhotoMetricDistortion — brightness/contrast/saturation/hue jitter,
    optionally asymmetric between left/right (asym=True draws independent
    params for the right image),
  * StereoPhotoMetricDistortion — per-frame asymmetric jitter,
  * Normalize — (x - mean) / std on the RGB images,
  * Pad — to a fixed size or a divisor; disparity pads 0, flow and
    disparity change pad BF_DEFAULT (= 210) and occlusion masks 1, so
    padded regions fail the validity mask,
  * RandomShiftRotate — small rectification noise on the right image,
  * RandomOcclude — patch-copy occlusion on the right image.

Each transform is a callable ``sample -> sample`` over the dict produced
by ``StereoVideoDataset``.  The random ones draw from an explicit
``np.random.Generator`` (their ``rng``); ``pipelines.build_train_pipeline``
gives them one shared generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

BF_DEFAULT = 1050 * 0.2

IMG_KEYS = ("imgs", "r_imgs")
DENSE_KEYS = ("gt_disp", "gt_flow", "gt_disp_change", "gt_flow_occ",
              "gt_disp2", "gt_disp_occ")
PAD_VALUES = {"imgs": 0.0, "r_imgs": 0.0, "gt_disp": 0.0, "gt_flow": BF_DEFAULT,
              "gt_disp_change": BF_DEFAULT, "gt_flow_occ": 1.0,
              "gt_disp2": 0.0, "gt_disp_occ": 1.0}

__all__ = ["RandomCrop", "PhotoMetricDistortion", "StereoPhotoMetricDistortion",
           "Normalize", "Pad", "RandomShiftRotate", "RandomOcclude",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


class RandomCrop:
    def __init__(self, crop_size: Tuple[int, int], rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        ch, cw = self.crop_size
        H, W = sample["imgs"].shape[1:3]
        y0 = int(self.rng.integers(0, max(H - ch, 0) + 1))
        x0 = int(self.rng.integers(0, max(W - cw, 0) + 1))
        for k in IMG_KEYS + DENSE_KEYS:
            if k in sample:
                sample[k] = sample[k][:, y0:y0 + ch, x0:x0 + cw]
        meta = sample["meta"]
        meta["img_shape"] = (min(ch, H), min(cw, W))
        if meta.get("intrinsics"):
            fx, fy, cx, cy = meta["intrinsics"]
            meta["intrinsics"] = [fx, fy, cx - x0, cy - y0]
        return sample


def _rgb_to_hsv(img):
    img = img / 255.0
    mx = img.max(-1)
    mn = img.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4)) * 60
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    c = v * s
    x = c * (1 - np.abs(h % 2 - 1))
    m = v - c
    z = np.zeros_like(c)
    idx = (h.astype(int) % 6)
    r = np.choose(idx, [c, x, z, z, x, c])
    g = np.choose(idx, [x, c, c, x, z, z])
    b = np.choose(idx, [z, z, x, c, c, x])
    return (np.stack([r, g, b], -1) + m[..., None]) * 255.0


def _jitter(img, rng, brightness=32, contrast=(0.5, 1.5),
            saturation=(0.5, 1.5), hue=18):
    """One photometric draw applied to a (..., 3) image in [0,255]."""
    img = img.astype(np.float32)
    if rng.integers(2):
        img = img + rng.uniform(-brightness, brightness)
    contrast_last = rng.integers(2)
    if not contrast_last and rng.integers(2):
        img = img * rng.uniform(*contrast)
    if rng.integers(2) or rng.integers(2):
        hsv = _rgb_to_hsv(np.clip(img, 0, 255))
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation), 0, 1)
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue)) % 360
        img = _hsv_to_rgb(hsv)
    if contrast_last and rng.integers(2):
        img = img * rng.uniform(*contrast)
    return np.clip(img, 0, 255)


class PhotoMetricDistortion:
    """Clip-consistent jitter of both images.  As in ``codd_tpu``, kept for
    equal bits: the left image draws from a copy of ``self.rng``'s state;
    with ``asym`` the right draws from ``self.rng`` itself, from that same
    state, so both get the same parameters (``asym`` only advances the
    generator); without it the right draws from a second copy and
    ``self.rng`` becomes the left's copy, so after the first call this
    transform no longer advances the generator the pipeline shares
    (``pipelines.pipeline_rng_state`` follows that)."""

    def __init__(self, asym: bool = False, rng: Optional[np.random.Generator] = None):
        self.asym = asym
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        state = self.rng.bit_generator.state
        rng_l = np.random.default_rng()
        rng_l.bit_generator.state = state
        sample["imgs"] = _jitter(sample["imgs"], rng_l)
        if self.asym:
            sample["r_imgs"] = _jitter(sample["r_imgs"], self.rng)
        else:
            rng_r = np.random.default_rng()
            rng_r.bit_generator.state = state
            sample["r_imgs"] = _jitter(sample["r_imgs"], rng_r)
            self.rng = rng_l
        return sample


class StereoPhotoMetricDistortion:
    """Per-frame asymmetric left/right jitter."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        for key in IMG_KEYS:
            frames = [
                _jitter(sample[key][t], self.rng)
                for t in range(sample[key].shape[0])
            ]
            sample[key] = np.stack(frames)
        return sample


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample):
        for k in IMG_KEYS:
            sample[k] = (sample[k] - self.mean) / self.std
        sample["meta"]["img_norm"] = {"mean": self.mean.tolist(),
                                      "std": self.std.tolist()}
        return sample


class Pad:
    """Pad to fixed size or to a divisor.  img_shape in meta keeps the
    pre-pad extent so evaluation can crop."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None):
        if (size is None) == (size_divisor is None):
            raise ValueError("Pad: give exactly one of size, size_divisor")
        self.size = size
        self.divisor = size_divisor

    def __call__(self, sample):
        H, W = sample["imgs"].shape[1:3]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.divisor
            th = -(-H // d) * d
            tw = -(-W // d) * d
        ph, pw = max(th - H, 0), max(tw - W, 0)
        if ph or pw:
            for k in IMG_KEYS + DENSE_KEYS:
                if k in sample:
                    pads = [(0, 0), (0, ph), (0, pw)] + [(0, 0)] * (sample[k].ndim - 3)
                    sample[k] = np.pad(sample[k], pads, constant_values=PAD_VALUES[k])
        sample["meta"]["img_shape"] = (H, W)
        sample["meta"]["pad_shape"] = (th, tw)
        return sample


def _affine_sample(img, mat):
    """Bilinear sample img (H,W,C) at affine-transformed coords."""
    H, W = img.shape[:2]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([xs, ys, np.ones_like(xs)], -1) @ mat.T
    x, y = coords[..., 0], coords[..., 1]
    x0 = np.clip(np.floor(x).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(y).astype(int), 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    out = (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
           + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)
    return out.astype(img.dtype)


class RandomShiftRotate:
    """Rectification noise: small random shift + rotation of the right
    image only."""

    def __init__(self, max_shift: float = 1.5, max_angle: float = 0.3,
                 prob: float = 0.5, rng: Optional[np.random.Generator] = None):
        self.max_shift = max_shift
        self.max_angle = max_angle
        self.prob = prob
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        if self.rng.random() > self.prob:
            return sample
        H, W = sample["r_imgs"].shape[1:3]
        ang = np.deg2rad(self.rng.uniform(-self.max_angle, self.max_angle))
        dy = self.rng.uniform(-self.max_shift, self.max_shift)
        dx = self.rng.uniform(-self.max_shift, self.max_shift)
        c, s = np.cos(ang), np.sin(ang)
        cx, cy = W / 2, H / 2
        # inverse map for sampling
        mat = np.array([[c, s, cx - c * cx - s * cy - dx],
                        [-s, c, cy + s * cx - c * cy - dy]], np.float64)
        sample["r_imgs"] = np.stack(
            [_affine_sample(f, mat) for f in sample["r_imgs"]])
        return sample


class RandomOcclude:
    """Patch-copy occlusion on the right image."""

    def __init__(self, w_range=(50, 100), h_range=(50, 100), prob: float = 0.5,
                 rng: Optional[np.random.Generator] = None):
        self.w_range = w_range
        self.h_range = h_range
        self.prob = prob
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        if self.rng.random() > self.prob:
            return sample
        T, H, W, _ = sample["r_imgs"].shape
        ph = int(self.rng.integers(*self.h_range))
        pw = int(self.rng.integers(*self.w_range))
        ph, pw = min(ph, H // 2), min(pw, W // 2)
        sy, sx = (int(self.rng.integers(0, H - ph)),
                  int(self.rng.integers(0, W - pw)))
        dy, dx = (int(self.rng.integers(0, H - ph)),
                  int(self.rng.integers(0, W - pw)))
        for t in range(T):
            patch = sample["r_imgs"][t, sy:sy + ph, sx:sx + pw].copy()
            sample["r_imgs"][t, dy:dy + ph, dx:dx + pw] = patch
        return sample
