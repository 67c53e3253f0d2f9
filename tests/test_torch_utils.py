"""The port's split-file and point-cloud utilities against codd_tpu's.

* ``utils/generate_split_files.py``: each of the five generators on a
  synthetic dataset tree, every split file byte-equal to codd_tpu's;
* ``utils/vis_point_cloud.py``: ``disparity_to_points`` (on the CPU
  tensor it is given) the same points in the same order (within 1e-6
  relative) and colors, PLY files byte-equal, ``_render_points`` images
  equal, ``render_video`` where OpenCV is installed and its ImportError
  where it is not, and the CLI.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from codd_tpu.utils import generate_split_files as jsplit
from codd_tpu.utils import vis_point_cloud as jvis
from codd_torch.utils import generate_split_files as tsplit
from codd_torch.utils import vis_point_cloud as tvis

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

INTR = (721.54, 721.54, 62.0, 18.5)
CALIB = 384.38


def _touch(root: Path, rel: str):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b"")


def _tree(root: Path, dataset: str):
    """A small tree in the dataset's official layout."""
    if dataset == "sceneflow":
        for sub in ("TRAIN", "TEST"):
            for scene in ("A/0001", "A/0010", "B/0002"):
                for i in (6, 7, 8, 9, 10, 11):
                    for side in ("left", "right"):
                        _touch(root, f"{sub}/{scene}/{side}/{i:04d}.png")
    elif dataset == "kitti_depth":
        drives = (jsplit.KITTI_DEPTH_VAL_DRIVES
                  + jsplit.KITTI_DEPTH_TEST_DRIVES[:3]
                  + ["2011_09_26/2011_09_26_drive_0001_sync",
                     "2011_09_30/2011_09_30_drive_0018_sync"])
        for d in drives:
            for i in (0, 1, 2, 10):
                for cam in ("image_02", "image_03"):
                    _touch(root, f"{d}/{cam}/data/{i:010d}.png")
    elif dataset == "kitti_2015":
        for s in range(12):
            for f in (10, 11, 12):
                for cam in ("image_2", "image_3"):
                    _touch(root, f"training/{cam}/{s:06d}_{f}.png")
    elif dataset == "tartanair":
        for env in ("abandonedfactory/Easy/P000", "office/Hard/P002"):
            for i in range(12):
                for side in ("left", "right"):
                    _touch(root, f"{env}/image_{side}/{i:06d}_{side}.png")
    else:  # sintel
        for scene in ("alley_1", "alley_2", "ambush_10", "ambush_2",
                      "bamboo_1", "bandage_1", "cave_2", "market_5",
                      "mountain_1", "shaman_2", "sleeping_1", "temple_3"):
            for i in (1, 2, 10):
                for side in ("final_left", "final_right"):
                    _touch(root, f"training/{side}/{scene}/frame_{i:04d}.png")


@pytest.mark.parametrize("dataset", sorted(jsplit.GENERATORS))
def test_split_files_equal_codd_tpu(tmp_path, dataset, capsys):
    assert sorted(tsplit.GENERATORS) == sorted(jsplit.GENERATORS)
    root = tmp_path / "data"
    _tree(root, dataset)
    outs = {}
    for side, mod in (("j", jsplit), ("t", tsplit)):
        out = tmp_path / side
        mod.main([dataset, str(root), "--output-path", str(out)])
        outs[side] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert sorted(outs["t"]) == [f"{dataset}_{s}.txt"
                                 for s in ("test", "train", "val")]
    assert outs["t"] == outs["j"]
    assert any(outs["t"].values())
    assert tsplit.natural_key("a10b2") == jsplit.natural_key("a10b2")


def _disp(rng, h=24, w=40):
    """Disparities with zeros, negatives, NaN, inf and depths past
    max_depth."""
    d = rng.uniform(0.5, 60.0, (h, w)).astype(np.float32)
    d[rng.rand(h, w) < 0.1] = 0.0
    d[rng.rand(h, w) < 0.05] = -3.0
    d[rng.rand(h, w) < 0.05] = rng.uniform(1e-4, 3.0, 1)[0]  # far
    d[0, 0], d[0, 1] = np.nan, np.inf
    return d


@pytest.mark.parametrize("with_image", [False, True])
def test_disparity_to_points_matches(with_image):
    rng = np.random.RandomState(0)
    d = _disp(rng)
    img = (rng.rand(*d.shape, 3) * 255).astype(np.float32) if with_image \
        else None
    jp, jc = jvis.disparity_to_points(d, INTR, CALIB, image=img)
    tp, tc = tvis.disparity_to_points(
        torch.from_numpy(d), INTR, CALIB,
        image=None if img is None else torch.from_numpy(img))
    assert 0 < len(tp) < d.size
    assert tp.shape == jp.shape and tc.shape == jc.shape
    assert np.abs(tp - jp).max() <= 1e-6 * np.abs(jp).max()
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == jc.dtype == np.uint8


def test_ply_and_render_equal_codd_tpu(tmp_path):
    rng = np.random.RandomState(1)
    disp = np.stack([_disp(rng) for _ in range(3)])
    npz = tmp_path / "seq.disp.pred.npz"
    np.savez_compressed(npz, disp=disp)
    j = jvis.npz_to_ply(str(npz), str(tmp_path / "j"), INTR, CALIB)
    t = tvis.npz_to_ply(str(npz), str(tmp_path / "t"), INTR, CALIB,
                        device="cpu")
    assert [os.path.basename(p) for p in t] == [os.path.basename(p)
                                                for p in j]
    assert len(t) == 3
    for a, b in zip(t, j):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    pts, col = jvis.disparity_to_points(disp[1], INTR, CALIB)
    for yaw in (0.0, 5.0):
        np.testing.assert_array_equal(
            tvis._render_points(pts, col, INTR, (80, 48), yaw),
            jvis._render_points(pts, col, INTR, (80, 48), yaw))


def test_render_video(tmp_path, monkeypatch):
    """An mp4 of the orbiting render where OpenCV is installed; a clear
    ImportError where it is not."""
    npz = tmp_path / "seq.disp.pred.npz"
    np.savez_compressed(npz, disp=np.stack([_disp(np.random.RandomState(i))
                                            for i in range(3)]))
    try:
        import cv2  # noqa: F401
    except ImportError:
        cv2 = None
    if cv2 is not None:
        out = tvis.render_video([str(npz)], str(tmp_path / "t.mp4"), INTR,
                                CALIB, size=(80, 48), device="cpu")
        assert Path(out).stat().st_size > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        tvis.render_video([str(npz)], str(tmp_path / "u.mp4"), INTR, CALIB,
                          device="cpu")


def test_cli(tmp_path, capsys):
    npz = tmp_path / "a" / "seq.disp.pred.npz"
    npz.parent.mkdir()
    np.savez_compressed(npz, disp=_disp(np.random.RandomState(2)))
    out = tmp_path / "clouds"
    assert tvis.main([str(tmp_path / "a" / "*.disp.pred.npz"), "--out-dir",
                      str(out), "--device", "cpu"]) == 0
    assert [p.name for p in out.iterdir()] == ["seq.disp.pred.000.ply"]
    assert "1 ply files" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert tvis.main([str(npz), "--out-dir", str(out)]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
