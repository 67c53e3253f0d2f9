"""The one traffic generator: seeded layered stereo scenes made on the
device, whose disparity agrees with the images in closed form.

Each clip row is a street seen by a rectified stereo rig of focal length
``fx`` (the traffic's intrinsics) and ``scene.baseline_m``:

* the background: a far wall at ``scene.far_disparity`` above the
  ground, and the ground plane, whose disparity on image row y is
  ``baseline_m / camera_height_m * (y - cy)`` (a flat road seen by a
  camera that high), each rounded to whole pixels;
* ``scene.objects`` fronto-parallel boxes, each at a depth drawn in
  ``scene.object_depth_m`` (disparity ``fx * baseline_m / depth``, whole
  pixels), standing on the ground at that depth, ``object_size_m`` wide
  and high (drawn), so nearer boxes are larger, lower and occlude more.

Each layer carries its own smooth texture (uniform noise on a grid of
``texture_cell`` pixels, bilinearly upsampled, plus ``fine_noise`` of
pixel noise).  Over a sequence the camera pans ``pan_px`` a frame (the
background's texture slides), each box moves ``object_speed_px`` (a
whole number drawn in +-that) a frame and nears or recedes by a whole
pixel of disparity a frame (drawn in -1, 0, +1).  Both views are
rendered by the same depth test (the larger disparity in front), so
boxes occlude the background and each other, and the right view shows
each visible point ``disparity`` whole pixels to the left of the left
view's: exact wherever the point is visible in both views.

Images are 0-255 intensities normalised by ImageNet's mean and standard
deviation and zero-padded at the bottom and right to a multiple of
``pad_divisor``, as ``codd_torch``'s test pipeline (Normalize, then Pad)
prepares a frame.  Nothing here depends on the program."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["sub_seed", "generator", "padded_shape", "stereo_clips",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one named use of ``seed`` (any whole number)."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def padded_shape(frame: Sequence[int], divisor: int) -> Tuple[int, int]:
    h, w = frame
    return -(-h // divisor) * divisor, -(-w // divisor) * divisor


def _textures(gen, n: int, h: int, w: int, scene: Dict, device) -> torch.Tensor:
    """``n`` normalised textures (n, 3, h * w), flattened for gathers."""
    cell = int(scene["texture_cell"])
    fine = float(scene["fine_noise"])
    base = torch.rand((n, 3, h // cell + 2, w // cell + 2), generator=gen, device=device)
    tex = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    tex = tex + fine * torch.rand(tex.shape, generator=gen, device=device)
    tex = tex * (255.0 / (1.0 + fine))
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    return ((tex - mean) / std).flatten(2)


def _uniform_int(gen, lo, hi, shape, device) -> torch.Tensor:
    """Whole numbers uniform in [lo, hi] (tensors or numbers) of ``shape``."""
    u = torch.rand(shape, generator=gen, device=device)
    return (lo + torch.floor(u * (hi - lo + 1))).long()


def stereo_clips(gen: torch.Generator, rows: int, frames: int,
                 frame: Sequence[int], scene: Dict, intrinsics: Sequence[float], device,
                 pad_divisor: int = 1, disparity: bool = False) -> Dict[str, List[torch.Tensor]]:
    """``rows`` clips of ``frames`` frames: per frame t, ``left[t]`` and
    ``right[t]`` (rows, Hp, Wp, 3) f32; with ``disparity`` also each
    view's disparity, ``disp[t]`` and ``disp_right[t]`` (rows, H, W), in
    whole pixels."""
    h, w = frame
    hp, wp = padded_shape(frame, pad_divisor)
    fx, cy = float(intrinsics[0]), float(intrinsics[3])
    base_m = float(scene["baseline_m"])
    fb = fx * base_m
    K, T = int(scene["objects"]), frames
    pan = int(scene["pan_px"])

    # the background: disparity by image row, the far wall or the ground
    y = torch.arange(h, device=device)
    far = _uniform_int(gen, *scene["far_disparity"], (rows, 1), device)
    ground = torch.round(base_m / float(scene["camera_height_m"]) * (y - cy)).long()
    bg_d = torch.maximum(far, ground[None, :])                     # (rows, h)
    bg_w = w + pan * (T - 1) + int(bg_d.max())
    bg_tex = _textures(gen, rows, h, bg_w, scene, device)

    # the boxes: depth, size, place and motion
    z_lo, z_hi = scene["object_depth_m"]
    depth = z_lo + (z_hi - z_lo) * torch.rand((rows, K), generator=gen, device=device)
    d0 = torch.round(fb / depth).long().clamp(min=1)
    (wl, wh), (hl, hh) = scene["object_size_m"]
    size_w = wl + (wh - wl) * torch.rand((rows, K), generator=gen, device=device)
    size_h = hl + (hh - hl) * torch.rand((rows, K), generator=gen, device=device)
    ow = torch.round(size_w * d0 / base_m).long().clamp(1, w)
    oh = torch.round(size_h * d0 / base_m).long().clamp(1, h)
    foot = torch.round(cy + d0 * float(scene["camera_height_m"]) / base_m).long()
    oy = foot - oh                                                  # top row
    ox = _uniform_int(gen, -ow // 2, w - (ow + 1) // 2, (rows, K), device)
    speed = int(scene["object_speed_px"])
    ov = _uniform_int(gen, -speed, speed, (rows, K), device)
    ostep = _uniform_int(gen, -1, 1, (rows, K), device)
    ob_h, ob_w = int(oh.max()), int(ow.max())
    ob_tex = _textures(gen, rows * K, ob_h, ob_w, scene, device).view(rows, K, 3, -1)

    cols = torch.arange(w, device=device).view(1, 1, w)
    yy = y.view(1, h, 1)

    def gather(tex, idx):   # tex (rows, 3, n), idx (rows, h, w) -> (rows, 3, h, w)
        idx = idx.expand(rows, h, w).reshape(rows, 1, h * w)
        return torch.gather(tex, 2, idx.expand(rows, 3, h * w)).view(rows, 3, h, w)

    def render(t: int, right: bool):
        """One view at frame t: the image (rows, 3, h, w) and disparity."""
        d = bg_d[:, :, None].expand(rows, h, w)
        x = cols + (d if right else 0)             # the left-view column of the point
        img = gather(bg_tex, yy * bg_w + (x + pan * t).clamp(0, bg_w - 1))
        for k in range(K):
            dk = (d0[:, k] + ostep[:, k] * t).clamp(min=1).view(rows, 1, 1)
            xk = cols + (dk if right else 0)
            u = xk - (ox[:, k] + ov[:, k] * t).view(rows, 1, 1)
            v = yy - oy[:, k].view(rows, 1, 1)
            cover = ((u >= 0) & (u < ow[:, k].view(rows, 1, 1))
                     & (v >= 0) & (v < oh[:, k].view(rows, 1, 1)) & (dk >= d))
            idx = v.clamp(0, ob_h - 1) * ob_w + u.clamp(0, ob_w - 1)
            img = torch.where(cover[:, None], gather(ob_tex[:, k], idx), img)
            d = torch.where(cover, dk, d)
        return img, d

    def padded(img):
        return F.pad(img, (0, wp - w, 0, hp - h)).permute(0, 2, 3, 1).contiguous()

    out = {"left": [], "right": [], "disp": [], "disp_right": []}
    for t in range(T):
        for view, key in ((False, "left"), (True, "right")):
            img, d = render(t, view)
            out[key].append(padded(img))
            if disparity:
                out["disp" if key == "left" else "disp_right"].append(d)
    if not disparity:
        del out["disp"], out["disp_right"]
    return out
