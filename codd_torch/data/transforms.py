"""Formatting transforms of the test-time pipeline (host-side numpy; the
port's own copy of what ``codd_tpu/data/transforms.py`` runs at test
time):

  * Normalize — (x - mean) / std on the RGB images,
  * Pad — to a fixed size or a divisor; disparity pads 0, flow and
    disparity change pad BF_DEFAULT (= 210) and occlusion masks 1, so
    padded regions fail the validity mask.

Each transform is a callable ``sample -> sample`` over the dict produced
by ``StereoVideoDataset``.  The training augmentations are not part of
this package.
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

__all__ = ["Normalize", "Pad", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


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
