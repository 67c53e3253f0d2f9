"""The port's benchmark entry points on the CPU at 64x128:
``python -m codd_torch.tools.bench`` (the counterpart of ``bench.py``) in
both precisions, batched and in frame-0 mode, and ``codd_torch.tools.
benchmark_speed``.  Each bench run's last line is ``bench.py``'s JSON
line; the numbers of a CPU run are no device metric and are not checked.
Without a card and without ``--device cpu`` the command fails with the
CUDA message."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from codd_torch.tools import bench, benchmark_speed

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--height", "64", "--width", "128", "--iters",
         "2", "--warmup", "1"]


@pytest.mark.parametrize("extra,metric", [
    ([], "fps_streaming_kitti_64x128"),
    (["--bf16"], "fps_streaming_kitti_64x128"),
    (["--batch", "2"], "fps_streaming_b2_kitti_64x128"),
    (["--mode", "frame0"], "fps_frame0_kitti_64x128"),
])
def test_bench_last_line_is_the_json_line(capsys, extra, metric):
    assert bench.main(SMALL + extra) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == metric and line["unit"] == "fps"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 60.0, 4)
    assert any(l.startswith("device: cpu") for l in lines[:-1])
    assert any(l.startswith("ms a call, each synced") for l in lines[:-1])


def test_bench_knobs_reach_the_model():
    """The flags build ``bench.py``'s model through ``model.runtime``; an
    unknown value raises there."""
    args = bench.parse_args(SMALL + ["--tile-warp", "pallas", "--gn-impl",
                                     "pallas_window", "--corr-impl",
                                     "patch", "--gn-iters", "3"])
    cfg = bench.model_config(args)
    assert cfg["motion"]["iters"] == 3
    assert cfg["runtime"]["tile_warp_variant"] == "pallas"
    from codd_torch.models.builder import build_estimator
    m = build_estimator(cfg, device="cpu", seed=None)
    assert m.motion.raft3d.pyramid_impl == "patch"
    assert m.stereo.tile_update.tile_update0.cv.form == "pallas"
    bad = bench.parse_args(SMALL + ["--corr-impl", "nope"])
    with pytest.raises(ValueError):
        build_estimator(bench.model_config(bad), device="cpu", seed=None)


def test_bench_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "codd_torch.tools.bench", "--height", "64",
         "--width", "128", "--iters", "1", "--warmup", "0"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert '"metric"' not in res.stdout


def test_benchmark_speed_prints_overall_fps(capsys):
    assert benchmark_speed.main([str(ROOT / "configs/models/codd.py"),
                                 "--device", "cpu", "--height", "64",
                                 "--width", "128", "--iters", "2",
                                 "--warmup", "1", "--streaming"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("Overall fps: ") and float(last.split()[-1]) > 0
