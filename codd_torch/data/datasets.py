"""Stereo-video datasets: clip grouping, annotation loading, presets (the
port's own copy of ``codd_tpu/data/datasets.py``, reading images through
``imageio`` only):

  * split-file driven: each line is ``left right disp [flow] [disp_change]
    [flow_occ] [disp2] [disp_occ]`` (missing columns / "None" paths load as
    zeros),
  * consecutive frames group into clips by a filename-prefix regex;
    ``num_frames > 0`` yields sliding windows of that length, test mode
    (num_frames=-1) whole sequences capped at 50 frames,
  * per-format decode backends (pfm / sintel / tartanair / kitti), with
    inf/NaN disparities replaced by BF_DEFAULT and optional reciprocal
    (depth -> disparity) conversion.

Samples are dicts of numpy arrays stacked over the clip axis:
  imgs/r_imgs (T,H,W,3) float32 RGB, gt_disp (T,H,W,1), gt_flow (T,H,W,2),
  gt_* likewise, plus a ``meta`` dict (intrinsics, disp_range, calib,
  img_shape, ori_shape, filename).
"""

from __future__ import annotations

import os.path as osp
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import io as dio
from .pipelines import build_test_pipeline

BF_DEFAULT = 1050 * 0.2
MF_MAX_SEQUENCE_LENGTH = 50

ANN_KEYS = ("disp", "flow", "disp_change", "flow_occ", "disp2", "disp_occ")

__all__ = ["StereoVideoDataset", "group_clips", "make_dataset",
           "build_test_dataset", "DATASET_PRESETS", "MF_MAX_SEQUENCE_LENGTH"]


def group_clips(entries: List[dict], num_frames: int, pattern: str,
                max_len: int = MF_MAX_SEQUENCE_LENGTH) -> List[List[dict]]:
    """Group consecutive entries into clips.

    num_frames > 0: overlapping sliding windows within a sequence.
    num_frames <= 0: whole sequences, capped at ``max_len`` frames.
    Sequence identity = filename with ``pattern`` stripped.
    """
    def prefix(e):
        return re.sub(pattern, "", e["filename"]) if pattern else e["filename"]

    clips: List[List[dict]] = []
    history: List[dict] = []
    for e in entries:
        if history and prefix(history[0]) != prefix(e):
            if num_frames <= 0 and history:
                clips.append(history)
            history = [e]
        elif num_frames <= 0 and len(history) >= max_len:
            clips.append(history)
            history = [e]
        else:
            history.append(e)
        if num_frames > 0 and len(history) == num_frames:
            clips.append(list(history))
            history.pop(0)
    if num_frames <= 0 and history:
        clips.append(history)
    return clips


def _load_image(path: str) -> np.ndarray:
    img = np.asarray(dio.imread(path), np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img[..., :3]


def _load_disp(path: str, backend: str, reciprocal: bool,
               calib: Optional[float], shape_hint) -> np.ndarray:
    if path is None or "None" in osp.basename(path):
        return np.zeros(shape_hint, np.float32)
    if backend == "pfm":
        d = dio.read_pfm(path)[0]
    elif backend == "sintel":
        d = dio.read_sintel_disparity(path)
    elif backend == "tartanair":
        d = dio.read_tartanair_npy(path)
    elif backend == "kitti":
        d = dio.read_kitti_disparity(path)
    else:
        d = _load_image(path)[..., -1]
    d = np.asarray(d, np.float32)
    if d.ndim == 3:
        d = d[..., -1]
    d = np.where(np.isinf(d) | np.isnan(d), BF_DEFAULT, d)
    if reciprocal:
        with np.errstate(divide="ignore"):
            d = 1.0 / d
        if calib is not None:
            d = calib * d
        d = np.where(np.isinf(d) | np.isnan(d), BF_DEFAULT, d)
    return d.astype(np.float32)


def _load_flow(path: str, backend: str, shape_hint) -> np.ndarray:
    if path is None or "None" in osp.basename(path):
        return np.zeros(shape_hint + (2,), np.float32)
    if backend == "pfm":
        f = dio.read_pfm(path)[0][..., :2]
    elif backend == "flo":
        f = dio.read_flo(path)
    elif backend == "tartanair":
        f = dio.read_tartanair_npy(path)[..., :2]
    elif backend == "kitti":
        f, _ = dio.read_kitti_flow(path)
    else:
        raise ValueError(f"unknown flow backend {backend}")
    return np.asarray(f, np.float32)


def _load_mask(path: str, backend: str, inverse: bool, shape_hint) -> np.ndarray:
    """Occlusion masks; output convention: >0 means occluded."""
    if path is None or "None" in osp.basename(path):
        return np.zeros(shape_hint, np.float32)
    if backend == "tartanair":
        m = dio.read_tartanair_npy(path)
    else:
        m = _load_image(path)[..., 0]
    m = np.asarray(m, np.float32)
    if inverse:
        m = (m <= 0).astype(np.float32)
    return m


class StereoVideoDataset:
    """Clip dataset over a split file (see module docstring)."""

    def __init__(
        self,
        split: str,
        data_root: Optional[str] = None,
        num_frames: int = 2,
        prefix_pattern: str = r"\d+.png",
        disp_backend: str = "pfm",
        flow_backend: str = "pfm",
        mask_backend: str = "png",
        flow_occ_inverse: bool = False,
        reciprocal_disp: bool = False,
        disp_range: Tuple[float, float] = (1.0, 210.0),
        calib: Optional[float] = None,
        intrinsics: Optional[Sequence[float]] = None,
        num_samples: Optional[int] = None,
        pipeline: Sequence[Callable] = (),
    ):
        self.data_root = data_root
        self.disp_backend = disp_backend
        self.flow_backend = flow_backend
        self.mask_backend = mask_backend
        self.flow_occ_inverse = flow_occ_inverse
        self.reciprocal_disp = reciprocal_disp
        self.disp_range = tuple(disp_range)
        self.calib = calib
        self.intrinsics = list(intrinsics) if intrinsics is not None else None
        self.pipeline = list(pipeline)

        entries = []
        with open(split) as f:
            for line in f:
                cols = line.strip().split()
                if not cols:
                    continue
                e = {"filename": cols[0],
                     "r_filename": cols[1] if len(cols) > 1 else None}
                for i, k in enumerate(ANN_KEYS):
                    e[k] = cols[2 + i] if len(cols) > 2 + i else None
                entries.append(e)
        self.clips = group_clips(entries, num_frames, prefix_pattern)
        if num_samples is not None and 0 < num_samples <= len(self.clips):
            self.clips = self.clips[:num_samples]

    @classmethod
    def from_dirs(cls, img_dir: str, r_img_dir: Optional[str] = None,
                  img_suffix: str = ".png", num_frames: int = -1,
                  prefix_pattern: str = r"\d+.png", **kwargs
                  ) -> "StereoVideoDataset":
        """Annotation-free mode: scan an image directory recursively and
        derive right-image paths by replacing 'left' with 'right' (the
        ``--img-dir`` mode of the inference CLI)."""
        import os

        files = []
        for root, _, names in os.walk(img_dir):
            for n in sorted(names):
                if n.endswith(img_suffix):
                    files.append(osp.relpath(osp.join(root, n), img_dir))
        files.sort()
        # names stay relative to img_dir (unlike codd_tpu, whose absolute
        # names make --show-dir write beside the input images)
        r_root = osp.abspath(r_img_dir or img_dir.replace("left", "right"))
        self = cls.__new__(cls)
        self.data_root = img_dir
        self.disp_backend = "pfm"
        self.flow_backend = "pfm"
        self.mask_backend = "png"
        self.flow_occ_inverse = False
        self.reciprocal_disp = False
        self.disp_range = tuple(kwargs.get("disp_range", (1.0, 210.0)))
        self.calib = kwargs.get("calib")
        intr = kwargs.get("intrinsics")
        self.intrinsics = list(intr) if intr is not None else None
        self.pipeline = list(kwargs.get("pipeline", ()))
        entries = []
        for f in files:
            e = {"filename": f,
                 "r_filename": osp.join(r_root, f.replace("left", "right"))}
            for k in ANN_KEYS:
                e[k] = None
            entries.append(e)
        self.clips = group_clips(entries, num_frames, prefix_pattern)
        return self

    def __len__(self):
        return len(self.clips)

    def sequence_name(self, idx: int) -> str:
        """Clip name without loading any data: the first frame's
        filename, the per-sequence key of the metric rows."""
        return self.clips[idx][0]["filename"]

    def _path(self, p: Optional[str]) -> Optional[str]:
        if p is None or p == "None":
            return None
        return osp.join(self.data_root, p) if self.data_root else p

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        clip = self.clips[idx]
        imgs, r_imgs = [], []
        anns: Dict[str, List[np.ndarray]] = {k: [] for k in ANN_KEYS}
        have: Dict[str, bool] = {k: False for k in ANN_KEYS}
        for e in clip:
            img = _load_image(self._path(e["filename"]))
            imgs.append(img)
            r_imgs.append(_load_image(self._path(e["r_filename"]))
                          if e["r_filename"] else np.zeros_like(img))
            hw = img.shape[:2]
            for k in ANN_KEYS:
                p = self._path(e[k])
                if e[k] is not None and "None" not in osp.basename(str(e[k])):
                    have[k] = True
                if k in ("disp", "disp_change", "disp2"):
                    reciprocal = self.reciprocal_disp if k != "disp_change" else False
                    anns[k].append(_load_disp(p, self.disp_backend, reciprocal,
                                              self.calib, hw)[..., None])
                elif k == "flow":
                    anns[k].append(_load_flow(p, self.flow_backend, hw))
                else:  # flow_occ / disp_occ
                    inv = self.flow_occ_inverse if k == "flow_occ" else False
                    anns[k].append(_load_mask(p, self.mask_backend, inv,
                                              hw)[..., None])

        sample: Dict[str, Any] = {
            "imgs": np.stack(imgs),
            "r_imgs": np.stack(r_imgs),
        }
        for k in ANN_KEYS:
            if have[k]:
                sample["gt_" + k] = np.stack(anns[k])
        H, W = sample["imgs"].shape[1:3]
        sample["meta"] = {
            "filename": clip[0]["filename"],
            "ori_shape": (H, W),
            "img_shape": (H, W),
            "disp_range": self.disp_range,
            "calib": self.calib,
            "intrinsics": (list(self.intrinsics)
                           if self.intrinsics is not None else None),
        }
        for t in self.pipeline:
            sample = t(sample)
        return sample


DATASET_PRESETS = {
    # suffix conventions and prefix patterns of each dataset
    "scene_flow": dict(prefix_pattern=r"\d+.png", disp_backend="pfm",
                       flow_backend="pfm"),
    "kitti_depth": dict(prefix_pattern=r"\d+.png", disp_backend="kitti",
                        flow_backend="kitti"),
    "kitti_2015": dict(prefix_pattern=r"_\d+.png", disp_backend="kitti",
                       flow_backend="kitti"),
    "sintel": dict(prefix_pattern=r"frame.*", disp_backend="sintel",
                   flow_backend="flo", flow_occ_inverse=False),
    "tartanair": dict(prefix_pattern=r"\d+_left.png", disp_backend="tartanair",
                      flow_backend="tartanair", mask_backend="tartanair",
                      reciprocal_disp=True),
}


def make_dataset(preset: str, **kwargs) -> StereoVideoDataset:
    base = dict(DATASET_PRESETS[preset])
    base.update(kwargs)
    return StereoVideoDataset(**base)


def build_test_dataset(dcfg: Dict[str, Any]) -> StereoVideoDataset:
    """A ``data.val`` / ``data.test`` config dict -> dataset with the
    test-time pipeline."""
    dcfg = dict(dcfg)
    preset = dcfg.pop("preset")
    dcfg.pop("augment", None)
    dcfg.pop("batch_size", None)
    pipeline = build_test_pipeline(dcfg.pop("pad_divisor", 64))
    return make_dataset(preset, pipeline=pipeline, **dcfg)
