"""The port's own copy of the test-time data layer against codd_tpu's:
codecs, clip grouping, the dataset over a generated on-disk tree, the test
pipeline, ``from_dirs`` and the running stats.  Host-side numpy on both
sides, the same code path for path: results are equal exactly."""

import os

import numpy as np
import pytest
import torch

from codd_tpu.data import datasets as jds
from codd_tpu.data import io as jio
from codd_tpu.data import pipelines as jpipe
from codd_tpu.utils import running_stats as jstats
from codd_torch.data import datasets as tds
from codd_torch.data import io as tio
from codd_torch.data import pipelines as tpipe
from codd_torch.data import transforms as ttf
from codd_torch.utils import running_stats as tstats

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


def _same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "meta":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import imageio.v2 as imageio
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    h, w = 40, 72
    lines = []
    for seq, n in (("a", 3), ("b", 2)):
        for i in range(n):
            for side in ("left", "right"):
                os.makedirs(root / side / seq, exist_ok=True)
                imageio.imwrite(str(root / side / seq / f"{i:04d}.png"),
                                (rng.rand(h, w, 3) * 255).astype(np.uint8))
            os.makedirs(root / "disp" / seq, exist_ok=True)
            disp = rng.uniform(2, 40, (h, w)).astype(np.float32)
            disp[0, 0] = np.inf
            jio.write_pfm(str(root / "disp" / seq / f"{i:04d}.pfm"), disp)
            os.makedirs(root / "flow" / seq, exist_ok=True)
            jio.write_pfm(str(root / "flow" / seq / f"{i:04d}.pfm"),
                          rng.uniform(-2, 2, (h, w, 3)).astype(np.float32))
            os.makedirs(root / "occ" / seq, exist_ok=True)
            imageio.imwrite(str(root / "occ" / seq / f"{i:04d}.png"),
                            ((rng.rand(h, w) > 0.8) * 255).astype(np.uint8))
            lines.append(" ".join([
                f"left/{seq}/{i:04d}.png", f"right/{seq}/{i:04d}.png",
                f"disp/{seq}/{i:04d}.pfm", f"flow/{seq}/{i:04d}.pfm",
                "None", f"occ/{seq}/{i:04d}.png"]))
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    return root, str(split)


def test_pfm_and_flo_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    for shape in ((7, 9), (7, 9, 3)):
        data = rng.randn(*shape).astype(np.float32)
        p = str(tmp_path / f"x{len(shape)}.pfm")
        tio.write_pfm(p, data)
        got, scale = tio.read_pfm(p)
        ref, rscale = jio.read_pfm(p)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(got, ref)
        assert scale == rscale == 1.0
    flow = rng.randn(5, 6, 2).astype(np.float32)
    p = str(tmp_path / "f.flo")
    tio.write_flo(p, flow)
    np.testing.assert_array_equal(tio.read_flo(p), flow)
    np.testing.assert_array_equal(jio.read_flo(p), flow)
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n-1\n")
    with pytest.raises(ValueError):
        tio.read_pfm(str(tmp_path / "bad.pfm"))


@pytest.mark.parametrize("kind", ["flow16", "gray16", "rgb8", "ga16",
                                  "rgba8"])
def test_png_decoder_every_filter(tmp_path, kind):
    """Hand-written PNGs whose rows use all five filter types: the port's
    decoder gives back the samples exactly, and KITTI's readers agree with
    codd_tpu's, which decode through its native C++ decoder."""
    from codd_tpu.data import native
    rng = np.random.RandomState(5)
    shape, dtype = {"flow16": ((11, 13, 3), np.uint16),
                    "gray16": ((11, 13), np.uint16),
                    "rgb8": ((11, 13, 3), np.uint8),
                    "ga16": ((7, 9, 2), np.uint16),
                    "rgba8": ((7, 9, 4), np.uint8)}[kind]
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[2] = img[1]                         # runs that Sub / Up / Paeth see
    img[:, 4] = img[:, 3]
    path = str(tmp_path / f"{kind}.png")
    tio.write_png(path, img, idat_chunks=2)
    got = tio.read_png(path)
    assert got.dtype == dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    assert native.native_available(), "codd_tpu's native decoder is built here"
    np.testing.assert_array_equal(native.decode(path), img.astype(np.float32))
    if kind == "flow16":
        flow, valid = tio.read_kitti_flow(path)
        rflow, rvalid = jio.read_kitti_flow(path)
        np.testing.assert_array_equal(flow, rflow)
        np.testing.assert_array_equal(valid, rvalid)
        np.testing.assert_array_equal(
            flow, (img[..., :2].astype(np.float32) - 2 ** 15) / 64.0)
        assert flow.dtype == valid.dtype == np.float32
    if kind == "gray16":
        got = tio.read_kitti_disparity(path)
        np.testing.assert_array_equal(got, jio.read_kitti_disparity(path))
        np.testing.assert_array_equal(got, img.astype(np.float32) / 256.0)


def test_png_decoder_rejects_what_it_does_not_cover(tmp_path):
    import struct
    import zlib
    (tmp_path / "x.png").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_png(str(tmp_path / "x.png"))
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0)      # palette
    body = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + ihdr
            + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)))
    (tmp_path / "p.png").write_bytes(body)
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_png(str(tmp_path / "p.png"))


def test_png_codecs_match(tmp_path):
    """KITTI 16-bit disparity and flow, Sintel disparity and segmentation:
    the port reads KITTI's PNGs with its own decoder and Sintel's through
    imageio, codd_tpu through its native decoder; the decoded values are
    equal.  The 16-bit RGB flow file is written by hand (PIL writes none);
    the port read it as 8 bits through imageio before it had a decoder."""
    import imageio.v2 as imageio
    rng = np.random.RandomState(2)
    d16 = (rng.rand(6, 8) * 60000).astype(np.uint16)
    imageio.imwrite(str(tmp_path / "d.png"), d16)
    np.testing.assert_array_equal(
        tio.read_kitti_disparity(str(tmp_path / "d.png")),
        jio.read_kitti_disparity(str(tmp_path / "d.png")))
    np.testing.assert_array_equal(
        tio.read_kitti_disparity(str(tmp_path / "d.png")),
        d16.astype(np.float32) / 256.0)
    f16 = (rng.rand(6, 8, 3) * 60000).astype(np.uint16)
    tio.write_png(str(tmp_path / "f.png"), f16, idat_chunks=2)
    flow, valid = tio.read_kitti_flow(str(tmp_path / "f.png"))
    rflow, rvalid = jio.read_kitti_flow(str(tmp_path / "f.png"))
    np.testing.assert_array_equal(
        flow, (f16[..., :2].astype(np.float32) - 2 ** 15) / 64.0)
    np.testing.assert_array_equal(valid, f16[..., 2].astype(np.float32))
    np.testing.assert_array_equal(flow, rflow)
    np.testing.assert_array_equal(valid, rvalid)
    rgb = (rng.rand(6, 8, 3) * 255).astype(np.uint8)
    imageio.imwrite(str(tmp_path / "s.png"), rgb)
    np.testing.assert_allclose(
        tio.read_sintel_disparity(str(tmp_path / "s.png")),
        jio.read_sintel_disparity(str(tmp_path / "s.png")))
    np.testing.assert_array_equal(
        tio.read_sintel_segmentation(str(tmp_path / "s.png")),
        jio.read_sintel_segmentation(str(tmp_path / "s.png")))
    np.save(str(tmp_path / "t.npy"), rng.rand(4, 5))
    np.testing.assert_array_equal(
        tio.read_tartanair_npy(str(tmp_path / "t.npy")),
        jio.read_tartanair_npy(str(tmp_path / "t.npy")))


@pytest.mark.parametrize("channels", [3, 4])
def test_16bit_colour_png_image_matches(tmp_path, channels):
    """A 16-bit RGB / RGBA image (or mask) through the dataset's image
    reader: codd_tpu decodes it natively to its 16-bit samples; the port
    reads it with ``read_png`` (imageio dropped the low byte), equal."""
    rng = np.random.RandomState(7)
    img = (rng.rand(6, 9, channels) * 65535).astype(np.uint16)
    img[0, 0] = 0x0102  # a low byte imageio would lose
    path = str(tmp_path / "img16.png")
    tio.write_png(path, img, idat_chunks=2)
    got = tds._load_image(path)
    np.testing.assert_array_equal(got, jds._load_image(path))
    np.testing.assert_array_equal(got, img[..., :3].astype(np.float32))


@pytest.mark.parametrize("num_frames", [-1, 2, 3])
def test_group_clips_matches(num_frames):
    entries = [{"filename": f"{s}/{i:04d}.png"} for s, n in
               (("a", 4), ("b", 1), ("c", 3)) for i in range(n)]
    got = tds.group_clips(entries, num_frames, r"\d+.png", max_len=3)
    ref = jds.group_clips(entries, num_frames, r"\d+.png", max_len=3)
    assert got == ref and len(got) > 0


@pytest.mark.parametrize("num_frames", [-1, 2])
def test_dataset_matches(tree, num_frames):
    root, split = tree
    kw = dict(split=split, data_root=str(root), num_frames=num_frames,
              disp_range=(1.0, 210.0), calib=1050.0,
              intrinsics=[100, 100, 36, 20])
    got = tds.make_dataset("scene_flow",
                           pipeline=tpipe.build_test_pipeline(64), **kw)
    ref = jds.make_dataset("scene_flow",
                           pipeline=jpipe.build_test_pipeline(64), **kw)
    assert len(got) == len(ref) == (2 if num_frames < 0 else 3)
    assert tds.DATASET_PRESETS == jds.DATASET_PRESETS
    for i in range(len(got)):
        assert got.sequence_name(i) == ref.sequence_name(i)
        _same_sample(got[i], ref[i])
    s = got[0]
    assert s["imgs"].shape[1:] == (64, 128, 3)          # padded to 64s
    assert s["meta"]["img_shape"] == (40, 72)
    assert s["gt_flow"][0, -1, -1, 0] == ttf.BF_DEFAULT  # flow pads 210
    assert s["gt_disp"][0, 0, 0, 0] == ttf.BF_DEFAULT    # inf -> 210
    assert "gt_flow_occ" in s and "gt_disp_change" not in s


def test_build_test_dataset_and_from_dirs(tree):
    from codd_tpu.apis.train import build_dataset_from_cfg
    root, split = tree
    dcfg = dict(preset="scene_flow", split=split, data_root=str(root),
                num_frames=-1, pad_divisor=32, num_samples=1, batch_size=4,
                augment=dict(photometric=False))
    got, ref = tds.build_test_dataset(dcfg), build_dataset_from_cfg(
        dcfg, train=False)
    assert len(got) == len(ref) == 1
    _same_sample(got[0], ref[0])
    assert got[0]["imgs"].shape[1:3] == (64, 96)
    gd = tds.StereoVideoDataset.from_dirs(
        str(root / "left"), pipeline=tpipe.build_test_pipeline(64))
    rd = jds.StereoVideoDataset.from_dirs(
        str(root / "left"), pipeline=jpipe.build_test_pipeline(64))
    assert len(gd) == len(rd) == 2
    got, ref = gd[1], rd[1]
    # deliberate difference: the port's names stay relative to img_dir, so
    # --show-dir output lands under the show dir, not beside the images
    assert got["meta"].pop("filename") == "b/0000.png"
    assert ref["meta"].pop("filename") == str(root / "left" / "b" / "0000.png")
    _same_sample(got, ref)
    assert "gt_disp" not in gd[0]


def test_pad_rejects_ambiguous_arguments():
    with pytest.raises(ValueError):
        ttf.Pad()
    with pytest.raises(ValueError):
        ttf.Pad(size=(4, 4), size_divisor=2)
    sample = {"imgs": np.zeros((1, 5, 6, 3), np.float32),
              "r_imgs": np.zeros((1, 5, 6, 3), np.float32), "meta": {}}
    out = ttf.Pad(size=(8, 8))(sample)
    assert out["imgs"].shape == (1, 8, 8, 3)
    assert out["meta"]["pad_shape"] == (8, 8)


def test_running_stats_match(tmp_path):
    rng = np.random.RandomState(3)
    rows = rng.rand(5, 4)
    halves = []
    for mod in (tstats, jstats):
        a = mod.RunningStatsWithBuffer(header=["k", "a", "b", "c", "d"])
        b = mod.RunningStatsWithBuffer()
        for i, r in enumerate(rows):
            (a if i < 3 else b).push(f"s{i}", r)
        merged = a + b
        path = merged.dump(str(tmp_path / f"{mod.__name__}.csv"))
        halves.append((merged.n, merged.mean, merged.variance(),
                       open(path).read()))
        meter = mod.AverageMeter()
        meter.update(2.0, 3)
        meter.update(4.0)
        assert meter.avg == 2.5
    assert halves[0][0] == halves[1][0] == 5
    np.testing.assert_array_equal(halves[0][1], halves[1][1])
    np.testing.assert_array_equal(halves[0][2], halves[1][2])
    assert halves[0][3] == halves[1][3]
    np.testing.assert_allclose(halves[0][1], rows.mean(0))
    with pytest.raises(ValueError):
        tstats.RunningStatsWithBuffer().dump()
