"""The port's training data layer against ``codd_tpu``'s, on seeded
synthetic arrays: each augmentation, ``build_train_pipeline``,
``collate`` and ``batch_iterator`` equal in bits under the same seed; the
pipeline's generator state round trip that resume relies on; the
``Prefetcher`` passing a loader error on; ``to_device``; and the native
PNG decoder against ``read_png`` and imageio for every filter type, 8 and
16 bits and 1-4 channels, with ``imread`` reading PNGs without imageio and
a failed build raising."""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from codd_tpu.data import loader as jloader
from codd_tpu.data import pipelines as jpipelines
from codd_tpu.data import transforms as jtransforms
from codd_torch.data import io as dio
from codd_torch.data import loader, native, pipelines, transforms

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)


def _sample(seed, T=2, H=40, W=56, intrinsics=(100.0, 100.0, 28.0, 20.0)):
    rng = np.random.default_rng(seed)
    return {
        "imgs": (rng.random((T, H, W, 3)) * 255).astype(np.float32),
        "r_imgs": (rng.random((T, H, W, 3)) * 255).astype(np.float32),
        "gt_disp": rng.uniform(1, 60, (T, H, W, 1)).astype(np.float32),
        "gt_flow": rng.uniform(-3, 3, (T, H, W, 2)).astype(np.float32),
        "meta": {"filename": f"s{seed}", "img_shape": (H, W),
                 "intrinsics": list(intrinsics)},
    }


def _equal(a, b):
    """Two samples (or batches) equal in bits, meta included."""
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


TRANSFORMS = {
    "crop": lambda m, rng: m.RandomCrop((24, 32), rng=rng),
    "photometric": lambda m, rng: m.PhotoMetricDistortion(rng=rng),
    "photometric_asym": lambda m, rng: m.PhotoMetricDistortion(
        asym=True, rng=rng),
    "stereo_photometric": lambda m, rng: m.StereoPhotoMetricDistortion(
        rng=rng),
    "shift_rotate": lambda m, rng: m.RandomShiftRotate(prob=0.7, rng=rng),
    "occlude": lambda m, rng: m.RandomOcclude(w_range=(5, 20),
                                              h_range=(5, 15), rng=rng),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_augmentation_equals_codd_tpu(name):
    """Six calls in a row from one seeded generator (so the draws that
    change the generator, and PhotoMetricDistortion's swap of it, show)."""
    port = TRANSFORMS[name](transforms, np.random.default_rng(3))
    ref = TRANSFORMS[name](jtransforms, np.random.default_rng(3))
    for i in range(6):
        _equal(port(_sample(i)), ref(_sample(i)))


def test_random_crop_shifts_the_principal_point():
    s = transforms.RandomCrop((24, 32), rng=np.random.default_rng(1))(
        _sample(0))
    src = _sample(0)
    fx, fy, cx, cy = s["meta"]["intrinsics"]
    x0, y0 = int(round(28.0 - cx)), int(round(20.0 - cy))
    assert s["imgs"].shape == (2, 24, 32, 3)
    assert np.array_equal(s["gt_flow"], src["gt_flow"][:, y0:y0 + 24,
                                                       x0:x0 + 32])


def test_hsv_round_trip_equals_codd_tpu():
    img = (np.random.default_rng(0).random((2, 9, 11, 3)) * 255
           ).astype(np.float32)
    hsv = transforms._rgb_to_hsv(img)
    assert np.array_equal(hsv, jtransforms._rgb_to_hsv(img))
    assert np.array_equal(transforms._hsv_to_rgb(hsv),
                          jtransforms._hsv_to_rgb(hsv))
    np.testing.assert_allclose(transforms._hsv_to_rgb(hsv), img, atol=1e-3)


AUGS = {
    "scene_flow": dict(crop_size=(24, 32), photometric=True, asym=True),
    "perturbed": dict(crop_size=(24, 32), stereo_photometric=True,
                      shift_rotate=True, occlude=True, pad_divisor=16),
}


@pytest.mark.parametrize("aug", sorted(AUGS))
def test_train_pipeline_equals_codd_tpu(aug):
    port = pipelines.build_train_pipeline(AUGS[aug], seed=5)
    ref = jpipelines.build_train_pipeline(AUGS[aug], seed=5)
    assert [type(t).__name__ for t in port] == [type(t).__name__ for t in ref]
    for i in range(5):
        a, b = _sample(i), _sample(i)
        for t in port:
            a = t(a)
        for t in ref:
            b = t(b)
        _equal(a, b)


@pytest.mark.parametrize("aug", sorted(AUGS))
def test_pipeline_rng_state_round_trip(aug):
    """A second pipeline given the first's generator state after 3 samples
    draws what the first draws next (PhotoMetricDistortion's swapped
    generator included)."""
    run = lambda pipe, i: _apply(pipe, _sample(i))  # noqa: E731
    first = pipelines.build_train_pipeline(AUGS[aug], seed=2)
    for i in range(3):
        run(first, i)
    state = pipelines.pipeline_rng_state(first)
    second = pipelines.build_train_pipeline(AUGS[aug], seed=2)
    pipelines.set_pipeline_rng_state(second, state)
    for i in range(3, 6):
        _equal(run(first, i), run(second, i))
    with pytest.raises(ValueError):
        pipelines.set_pipeline_rng_state(second[:-1], state)


def _apply(pipe, s):
    for t in pipe:
        s = t(s)
    return s


class _Data:
    """An in-memory dataset of 7 clips."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return _sample(i, H=8, W=12)


def test_collate_equals_codd_tpu():
    samples = [_sample(i, H=8, W=12) for i in range(3)]
    got = loader.collate(samples)
    _equal(got, jloader.collate([_sample(i, H=8, W=12) for i in range(3)]))
    assert got["l_img"].shape == (3, 2, 8, 12, 3)
    assert got["intrinsics"].dtype == np.float32


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True), dict(shuffle=False, drop_last=True),
    dict(shuffle=True, drop_last=False),
    dict(shuffle=True, drop_last=True, host_id=0, num_hosts=2),
    dict(shuffle=True, drop_last=True, host_id=1, num_hosts=2)])
def test_batch_iterator_equals_codd_tpu(kw):
    got = list(loader.batch_iterator(_Data(), 2, seed=4, epochs=3, **kw))
    want = list(jloader.batch_iterator(_Data(), 2, seed=4, epochs=3, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _equal(a, b)
    # skip passes over batches (across an epoch's end) without loading
    # them; the stream goes on as before
    n = len(got) // 2 + 1
    skipped = list(loader.batch_iterator(_Data(), 2, seed=4, epochs=3,
                                         skip=n, **kw))
    assert len(skipped) == len(got) - n
    for a, b in zip(skipped, got[n:]):
        _equal(a, b)


def test_batch_iterator_raises_without_a_batch():
    with pytest.raises(ValueError, match="no batch"):
        next(loader.batch_iterator(_Data(), 8))


def test_prefetcher_order_and_loader_error():
    assert list(loader.Prefetcher(iter(range(7)))) == list(range(7))

    def broken():
        yield 1
        raise OSError("missing frame")

    it = loader.Prefetcher(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="missing frame"):
        next(it)
    stuck = loader.Prefetcher(iter(range(100)))
    assert next(stuck) == 0
    stuck.close()  # the worker, blocked on the full queue, stops
    assert not stuck._thread.is_alive()


def test_to_device_on_the_cpu():
    b = loader.collate([_sample(i, H=8, W=12) for i in range(2)])
    b["gt_disp"] = b["gt_disp"].astype(np.float64)
    out = loader.to_device(b, "cpu")
    assert "meta" not in out and sorted(out) == sorted(set(b) - {"meta"})
    assert out["gt_disp"].dtype == torch.float32
    assert torch.equal(out["l_img"], torch.from_numpy(b["l_img"]))


# ---------------------------------------------------------------------------
# the native PNG decoder

@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4), (4, 3, 2, 1, 0, 4)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_native_decoder_equals_read_png(tmp_path, filters, dtype, channels):
    rng = np.random.default_rng(channels)
    hi = 256 if dtype == np.uint8 else 65536
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    img = rng.integers(0, hi, shape).astype(dtype)
    p = str(tmp_path / "x.png")
    dio.write_png(p, img, filters)
    got = native.decode(p)
    assert got.dtype == dtype and got.shape == img.shape
    assert np.array_equal(got, img)
    assert np.array_equal(got, dio.read_png(p))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_native_decoder_equals_imageio(tmp_path, channels):
    import imageio.v2 as imageio
    rng = np.random.default_rng(9)
    shape = (21, 30) if channels == 1 else (21, 30, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    p = str(tmp_path / "x.png")
    imageio.imwrite(p, img)  # imageio's own encoder and filter choice
    assert np.array_equal(native.decode(p), np.asarray(imageio.imread(p)))
    dio.write_png(p, img)  # the port's encoder, held by imageio's decoder
    assert np.array_equal(np.asarray(imageio.imread(p)), img)
    gray16 = rng.integers(0, 65536, (21, 30)).astype(np.uint16)
    dio.write_png(p, gray16)
    assert np.array_equal(native.decode(p), np.asarray(imageio.imread(p)))


def test_decode_batch_equals_decode(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"{i}.png"))
        dio.write_png(paths[-1],
                      rng.integers(0, 256, (9, 14, 3)).astype(np.uint8))
    for a, p in zip(native.decode_batch(paths, num_threads=3), paths):
        assert np.array_equal(a, dio.read_png(p))


def test_imread_reads_pngs_without_imageio(tmp_path, monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (10, 12, 3)
                                            ).astype(np.uint8)
    p = str(tmp_path / "x.png")
    dio.write_png(p, img)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    assert np.array_equal(dio.imread(p), img)
    with pytest.raises(ImportError):
        import imageio.v2  # noqa: F401


def test_failed_build_raises_with_the_log(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)build failed.*error"):
        native.build(src, tmp_path / "broken.so")
    assert not (tmp_path / "broken.so").exists()


def test_bad_filter_type_raises(tmp_path):
    p = tmp_path / "x.png"
    dio.write_png(str(p), np.zeros((4, 5), np.uint8), filters=(0,))
    buf = p.read_bytes()
    rows = bytearray(zlib.decompress(buf[33 + 8:][:-12 - 4]))
    rows[2 * 6] = 7  # row 2's filter byte
    data = zlib.compress(bytes(rows))
    head = buf[:33]
    idat = (struct.pack(">I", len(data)) + b"IDAT" + data
            + struct.pack(">I", zlib.crc32(b"IDAT" + data)))
    p.write_bytes(head + idat + buf[-12:])
    for fn in (native.decode, dio.read_png):
        with pytest.raises(ValueError, match="filter type 7 in row 2"):
            fn(str(p))
