"""Point clouds from predicted disparities (counterpart of
``codd_tpu/utils/vis_point_cloud.py``).

Turns the ``<name>.disp.pred.npz`` files that ``apis/inference.py``
writes (``--show-dir``) into PLY point clouds, or renders them into an mp4
with a slowly orbiting camera (the reference's video mode).
``disparity_to_points`` runs on the device of the disparity it is given;
the CLI runs it on the CUDA card unless ``--device cpu`` is given:

    python -m codd_torch.utils.vis_point_cloud "out/*.disp.pred.npz" \\
        [--out-dir point_clouds] [--video out.mp4] [--device cpu]

``--show`` opens the first cloud in open3d where it is installed; the
video writer is OpenCV's (``cv2``), imported only by ``render_video``.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import sys
from typing import Sequence

import numpy as np
import torch

__all__ = ["disparity_to_points", "write_ply", "npz_to_ply",
           "render_video", "main"]


def _true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, as numpy divides (on CUDA PyTorch multiplies by
    1 / b where b is a Python scalar)."""
    return a / torch.full_like(a, b)


def disparity_to_points(disp, intrinsics: Sequence[float], calib: float,
                        image=None, max_depth: float = 100.0):
    """Disparity (H, W) -> (N, 3) points (f64) and (N, 3) colors (uint8,
    0-255) as numpy arrays, computed on ``disp``'s device (a tensor on the
    card or the CPU, or a numpy array, taken on the CPU).  A pixel is a
    point where its disparity is > 0 and its depth calib / disp finite and
    below ``max_depth``; without ``image`` its color encodes the depth."""
    fx, fy, cx, cy = intrinsics
    d = torch.as_tensor(disp)
    if not d.is_floating_point():
        d = d.float()
    H, W = d.shape
    kw = dict(dtype=torch.float64, device=d.device)
    ys, xs = torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw),
                            indexing="ij")
    depth = torch.full_like(d, calib) / torch.clamp(d, min=1e-6)
    valid = (d > 0) & torch.isfinite(depth) & (depth < max_depth)
    z = depth[valid]
    zd = z.double()
    x = _true_div(xs[valid] - cx, fx) * zd
    y = _true_div(ys[valid] - cy, fy) * zd
    pts = torch.stack([x, y, zd], -1)
    if image is not None:
        img = torch.as_tensor(image).to(d.device)
        colors = img[valid][:, :3].to(torch.uint8)
    else:
        t = torch.clamp(_true_div(z, max_depth), 0, 1)
        colors = torch.stack([255 * t, 128 * (1 - t), 255 * (1 - t)],
                             -1).to(torch.uint8)
    return pts.cpu().numpy(), colors.cpu().numpy()


def write_ply(path: str, points: np.ndarray, colors: np.ndarray):
    """Binary little-endian PLY: float x, y, z and uchar red, green, blue
    a vertex."""
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(points)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\n"
                b"property uchar blue\n")
        f.write(b"end_header\n")
        rec = np.zeros(len(points),
                       dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        rec["xyz"] = points.astype(np.float32)
        rec["rgb"] = colors
        rec.tofile(f)


def _load_disp(npz_path: str) -> np.ndarray:
    disp = np.load(npz_path)["disp"]
    return disp[None] if disp.ndim == 2 else disp


def npz_to_ply(npz_path: str, out_dir: str, intrinsics, calib: float,
               device="cuda"):
    """One PLY file a frame of a ``.disp.pred.npz`` file, named
    ``<name>.disp.pred.<t>.ply`` in ``out_dir``; the points computed on
    ``device``."""
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for t, d in enumerate(_load_disp(npz_path)):
        pts, col = disparity_to_points(torch.from_numpy(d).to(device),
                                       intrinsics, calib)
        out = osp.join(out_dir,
                       osp.basename(npz_path).replace(".npz", f".{t:03d}.ply"))
        write_ply(out, pts, col)
        outs.append(out)
    return outs


def _render_points(points: np.ndarray, colors: np.ndarray, intrinsics,
                   size, yaw_deg: float = 0.0) -> np.ndarray:
    """Painter's-algorithm projection of a colored point cloud to an
    (H, W, 3) image (the stand-in for the reference's open3d offscreen
    render, vis_point_cloud.py:76-109): far points first, near ones over
    them."""
    W, H = size
    fx, fy, cx, cy = intrinsics
    th = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(th), 0, np.sin(th)],
                  [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    center = np.median(points, axis=0)
    p = (points - center) @ R.T + center
    z = p[:, 2]
    ok = z > 1e-3
    p, c, z = p[ok], colors[ok], z[ok]
    xs = np.round(fx * p[:, 0] / z + cx).astype(int)
    ys = np.round(fy * p[:, 1] / z + cy).astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    xs, ys, c, z = xs[ok], ys[ok], c[ok], z[ok]
    order = np.argsort(-z)  # far -> near
    img = np.zeros((H, W, 3), np.uint8)
    img[ys[order], xs[order]] = c[order]
    return img


def render_video(npz_paths, out_path: str, intrinsics, calib: float,
                 size=(960, 540), frame_rate: float = 10.0,
                 orbit_deg: float = 8.0, device="cuda"):
    """The reference's video mode (vis_point_cloud.py:76-109): each
    frame's point cloud rendered with a camera orbiting ``orbit_deg``,
    written as an mp4 by ``cv2.VideoWriter``.  Raises ImportError where
    OpenCV is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "render_video writes its mp4 through OpenCV (the cv2 module), "
            "which is not installed here; npz_to_ply writes the point "
            "clouds without it") from e

    disps = [_load_disp(f) for f in npz_paths]
    n_total = sum(len(d) for d in disps)
    frames, i = [], 0
    for disp in disps:
        for d in disp:
            pts, col = disparity_to_points(torch.from_numpy(d).to(device),
                                           intrinsics, calib)
            yaw = orbit_deg * np.sin(2 * np.pi * i / max(n_total, 1))
            frames.append(_render_points(pts, col, intrinsics, size, yaw))
            i += 1
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             frame_rate, size, isColor=True)
    for fr in frames:
        writer.write(fr[:, :, ::-1])  # RGB -> BGR
    writer.release()
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="Export predicted disparities "
                                            "as PLY point clouds")
    p.add_argument("pattern", help="glob of .disp.pred.npz files")
    p.add_argument("--out-dir", default="point_clouds")
    p.add_argument("--intrinsics", type=float, nargs=4,
                   default=[721.54, 721.54, 621.0, 187.5])
    p.add_argument("--calib", type=float, default=384.38)
    p.add_argument("--show", action="store_true",
                   help="interactive open3d viewer (if installed)")
    p.add_argument("--video", default=None,
                   help="render an orbiting-camera mp4 of the point clouds "
                        "(reference video mode) to this path")
    p.add_argument("--frame-rate", type=float, default=10.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available (or run with --device cpu)",
              file=sys.stderr)
        return 1

    files = sorted(glob.glob(args.pattern))
    if args.video and files:
        out = render_video(files, args.video, args.intrinsics, args.calib,
                           frame_rate=args.frame_rate, device=args.device)
        print(f"video -> {out}")
        return 0
    for f in files:
        outs = npz_to_ply(f, args.out_dir, args.intrinsics, args.calib,
                          args.device)
        print(f"{f} -> {len(outs)} ply files")
    if args.show and files:
        try:
            import open3d as o3d
        except ImportError:
            print("open3d not installed; PLY files written for offline "
                  "viewing")
            return 0
        pc = o3d.io.read_point_cloud(
            npz_to_ply(files[0], args.out_dir, args.intrinsics, args.calib,
                       args.device)[0])
        o3d.visualization.draw_geometries([pc])
    return 0


if __name__ == "__main__":
    sys.exit(main())
