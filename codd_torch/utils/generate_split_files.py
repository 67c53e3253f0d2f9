"""Split-file generator for the supported datasets (counterpart of
``codd_tpu/utils/generate_split_files.py``; the standard library only).

Writes the 8-column split format that ``data/datasets.py``'s
StereoVideoDataset reads:
  left right disp [flow] [disp_change] [flow_occ] [disp2] [disp_occ]
with literal ``None`` for an absent annotation, the reference generator's
output (utils/generate_split_files.py).  Run as

    python -m codd_torch.utils.generate_split_files DATASET DATA_ROOT \
        [--output-path splits] [--splits train val test]

Dataset layouts follow the official releases; the KITTI-Depth val/test
drive lists are the reference's fixed scene choices (data facts, kept
verbatim for split compatibility).
"""

from __future__ import annotations

import os
import os.path as osp
import re
from argparse import ArgumentParser
from typing import List, Optional

__all__ = ["natural_key", "split_sceneflow", "split_kitti_depth",
           "split_kitti_2015", "split_tartanair", "split_sintel",
           "GENERATORS", "main"]

KITTI_DEPTH_VAL_DRIVES = ["2011_10_03/2011_10_03_drive_0042_sync"]
KITTI_DEPTH_TEST_DRIVES = [
    "2011_09_26/2011_09_26_drive_0002_sync", "2011_09_26/2011_09_26_drive_0005_sync",
    "2011_09_26/2011_09_26_drive_0013_sync", "2011_09_26/2011_09_26_drive_0020_sync",
    "2011_09_26/2011_09_26_drive_0023_sync", "2011_09_26/2011_09_26_drive_0036_sync",
    "2011_09_26/2011_09_26_drive_0079_sync", "2011_09_26/2011_09_26_drive_0095_sync",
    "2011_09_26/2011_09_26_drive_0113_sync", "2011_09_28/2011_09_28_drive_0037_sync",
    "2011_09_29/2011_09_29_drive_0026_sync", "2011_09_30/2011_09_30_drive_0016_sync",
    "2011_10_03/2011_10_03_drive_0047_sync",
]


def natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _walk_images(root: str, must_contain: str, suffix: str = ".png") -> List[str]:
    out = []
    for r, _, files in os.walk(root):
        if must_contain in r:
            for f in files:
                if f.endswith(suffix):
                    out.append(osp.relpath(osp.join(r, f), root))
    return sorted(out, key=natural_key)


def _write(path: str, rows: List[List[Optional[str]]]):
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join("None" if c is None else c for c in row) + "\n")
    print(f"wrote {len(rows)} lines -> {path}")


def split_sceneflow(data_root: str, out: str, split: str, val_ratio: float = 0.05):
    sub = "TEST" if split == "test" else "TRAIN"
    lefts = _walk_images(osp.join(data_root, sub), "left")
    lefts = [osp.join(sub, p) for p in lefts]
    n_train = int(len(lefts) * (1 - val_ratio))
    if split == "train":
        lefts = lefts[:n_train]
    elif split == "val":
        lefts = lefts[n_train:]
    rows = []
    for li in lefts:
        idx = re.search(r"\d+.png", li).group()
        flow = li.replace("/left/", "/into_future/left/").replace(
            idx, "OpticalFlowIntoFuture_" + idx.replace(".png", "") + "_L.pfm")
        rows.append([
            li, li.replace("left", "right"), li.replace(".png", ".pfm"),
            flow,
            li.replace("/left/", "/into_future/left/").replace(".png", ".pfm"),
            None, None, None,
        ])
    _write(out, rows)


def split_kitti_depth(data_root: str, out: str, split: str):
    lefts = _walk_images(data_root, "image_02")

    def in_drives(p, drives):
        return any(d in p for d in drives)

    if split == "val":
        lefts = [p for p in lefts if in_drives(p, KITTI_DEPTH_VAL_DRIVES)]
    elif split == "test":
        lefts = [p for p in lefts if in_drives(p, KITTI_DEPTH_TEST_DRIVES)]
    else:
        excl = KITTI_DEPTH_VAL_DRIVES + KITTI_DEPTH_TEST_DRIVES
        lefts = [p for p in lefts if not in_drives(p, excl)]
    rows = []
    for li in lefts:
        ri = li.replace("image_02", "image_03")
        disp = li.replace("image_02/data", "proj_disp/groundtruth/image_02")
        disp2 = li.replace("image_02/data", "proj_disp/groundtruth_disp2/image_02")
        rows.append([li, ri, disp, None, None, None, disp2, None])
    _write(out, rows)


def split_kitti_2015(data_root: str, out: str, split: str, fold: int = 0):
    lefts = _walk_images(osp.join(data_root, "training"), "image_2")
    lefts = [osp.join("training", p) for p in lefts
             if re.search(r"_1[01].png", p)]
    # 5-fold split over the 200 scenes (reference convention)
    scenes = sorted({re.sub(r"_\d+.png", "", p) for p in lefts},
                    key=natural_key)
    val_scenes = set(scenes[fold::5])
    if split == "train":
        lefts = [p for p in lefts
                 if re.sub(r"_\d+.png", "", p) not in val_scenes]
    else:
        lefts = [p for p in lefts if re.sub(r"_\d+.png", "", p) in val_scenes]
    rows = []
    for li in lefts:
        base = osp.basename(li)
        is_first = base.endswith("_10.png")
        disp = (li.replace("image_2", "disp_occ_0")
                if is_first else "None.png")
        flow = li.replace("image_2", "flow_occ") if is_first else "None.png"
        disp2 = li.replace("image_2", "disp_occ_1") if is_first else "None.png"
        rows.append([li, li.replace("image_2", "image_3"), disp, flow, None,
                     None, disp2, None])
    _write(out, rows)


def split_tartanair(data_root: str, out: str, split: str, val_ratio: float = 0.05):
    lefts = _walk_images(data_root, "image_left")
    n_train = int(len(lefts) * (1 - val_ratio))
    lefts = lefts[:n_train] if split == "train" else lefts[n_train:]
    rows = []
    for li in lefts:
        idx = re.search(r"(\d+)_left.png", li)
        n = idx.group(1)
        rows.append([
            li, li.replace("image_left", "image_right").replace("_left.png", "_right.png"),
            li.replace("image_left", "depth_left").replace("_left.png", "_left_depth.npy"),
            li.replace("image_left", "flow").replace(f"{n}_left.png",
                                                     f"{n}_{int(n) + 1:06d}_flow.npy"),
            None,
            li.replace("image_left", "flow").replace(f"{n}_left.png",
                                                     f"{n}_{int(n) + 1:06d}_mask.npy"),
            None, None,
        ])
    _write(out, rows)


def split_sintel(data_root: str, out: str, split: str, val_ratio: float = 0.1):
    lefts = _walk_images(osp.join(data_root, "training"), "final_left")
    lefts = [osp.join("training", p) for p in lefts]
    scenes = sorted({osp.dirname(p) for p in lefts}, key=natural_key)
    n_train = int(len(scenes) * (1 - val_ratio))
    keep = set(scenes[:n_train] if split == "train" else scenes[n_train:])
    lefts = [p for p in lefts if osp.dirname(p) in keep]
    rows = []
    for li in lefts:
        rows.append([
            li, li.replace("final_left", "final_right"),
            li.replace("final_left", "disparities"),
            li.replace("final_left", "flow").replace(".png", ".flo"),
            None,
            li.replace("final_left", "occlusions"),
            None, None,
        ])
    _write(out, rows)


GENERATORS = {
    "sceneflow": split_sceneflow,
    "kitti_depth": split_kitti_depth,
    "kitti_2015": split_kitti_2015,
    "tartanair": split_tartanair,
    "sintel": split_sintel,
}


def main(argv=None):
    p = ArgumentParser(description="Generate dataset split files")
    p.add_argument("dataset", choices=sorted(GENERATORS))
    p.add_argument("data_root")
    p.add_argument("--output-path", default="splits")
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    args = p.parse_args(argv)
    for split in args.splits:
        out = osp.join(args.output_path, f"{args.dataset}_{split}.txt")
        GENERATORS[args.dataset](args.data_root, out, split)


if __name__ == "__main__":
    main()
