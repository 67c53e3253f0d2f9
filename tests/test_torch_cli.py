"""The inference CLI of the port, ``python -m codd_torch.tools.inference``,
in a subprocess on a generated tiny dataset: ``--device cpu --eval`` prints
the tables and writes the CSV, ``--show-dir`` saves the disparities, a
checkpoint round-trips, ``--bf16`` runs f32 compute on bf16-rounded
weights, and without ``--device cpu`` (and without a card) it exits
non-zero with the CUDA message."""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from codd_torch.apis.evaluation import METER_NAMES, SUM_NAMES
from codd_torch.config import load_config
from codd_torch.data.io import write_pfm
from codd_torch.models.builder import build_estimator
from codd_torch.tools.inference import parse_args
from codd_torch.utils.checkpoint import load_checkpoint, save_checkpoint

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "codd_torch.tools.inference", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    import imageio.v2 as imageio
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    h, w = 64, 128
    lines = []
    for seq in ("a", "b"):
        for i in range(2):
            for side in ("left", "right"):
                os.makedirs(root / side / seq, exist_ok=True)
                imageio.imwrite(str(root / side / seq / f"{i:04d}.png"),
                                (rng.rand(h, w, 3) * 255).astype(np.uint8))
            for kind, shape, lo, hi in (("disp", (h, w), 2, 40),
                                        ("flow", (h, w, 3), -2, 2)):
                os.makedirs(root / kind / seq, exist_ok=True)
                write_pfm(str(root / kind / seq / f"{i:04d}.pfm"),
                          rng.uniform(lo, hi, shape).astype(np.float32))
            lines.append(" ".join([
                f"left/{seq}/{i:04d}.png", f"right/{seq}/{i:04d}.png",
                f"disp/{seq}/{i:04d}.pfm", f"flow/{seq}/{i:04d}.pfm"]))
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    cfg = root / "cfg.py"
    cfg.write_text(f"""
model = dict(
    type="ConsistentOnlineDynamicDepth",
    stereo=dict(type="HITNetMF", initialization=dict(max_disp=64)),
    motion=None,
    fusion=None,
)
data = dict(
    test=dict(preset="scene_flow", split=r"{split}", data_root=r"{root}",
              num_frames=-1, disp_range=(1.0, 210.0), calib=1050,
              intrinsics=[100, 100, 64, 32], pad_divisor=64),
)
""")
    return root, str(cfg)


def test_parser_has_the_flags_of_the_jax_cli():
    a = parse_args(["cfg.py", "ckpt.pt", "--eval", "--show-dir", "d",
                    "--num-frames", "3", "--out-csv", "f.csv", "--split",
                    "val", "--img-dir", "l", "--r-img-dir", "r", "--bf16",
                    "--device", "cpu", "--options", "a.b=1", "c=x"])
    assert (a.config, a.checkpoint, a.eval, a.split) == (
        "cfg.py", "ckpt.pt", "default", "val")
    assert a.options == ["a.b=1", "c=x"] and a.bf16 and a.device == "cpu"
    assert parse_args(["cfg.py", "--eval", "motion_only"]).eval == "motion_only"
    d = parse_args(["cfg.py"])
    assert (d.checkpoint, d.eval, d.device, d.split) == (None, None, "cuda",
                                                         "test")


def test_cli_eval_on_cpu_prints_tables_and_writes_csv(tiny_env):
    root, cfg = tiny_env
    out_csv = str(root / "metrics.csv")
    res = _run(cfg, "--device", "cpu", "--eval", "--out-csv", out_csv)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("Summary:") == 2
    assert "| epe" in res.stdout and "epe2d_scene_flow" in res.stdout
    assert "'epe':" in res.stdout.splitlines()[-1]
    rows = list(csv.reader(open(out_csv)))
    assert rows[0] == ["filename"] + list(METER_NAMES) + list(SUM_NAMES)
    assert [r[0] for r in rows[1:]] == ["left/a/0000.png", "left/b/0000.png",
                                        "mean"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    # --num-frames caps the sequences, --eval disp_only drops a table
    res = _run(cfg, "--device", "cpu", "--eval", "disp_only", "--num-frames",
               "1", "--out-csv", out_csv)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("Summary:") == 1
    assert len(list(csv.reader(open(out_csv)))) == 3


def test_cli_checkpoint_and_show_dir(tiny_env):
    """A saved state_dict loads strictly and decides the output: two runs
    from the same checkpoint agree exactly, and differ from seed 0's."""
    root, cfg = tiny_env
    model = build_estimator(load_config(cfg)["model"], device="cpu", seed=7)
    ckpt = save_checkpoint(model, str(root / "w" / "model.pt"))
    fresh = build_estimator(load_config(cfg)["model"], device="cpu", seed=0)
    load_checkpoint(fresh, ckpt)
    for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    show = root / "show"
    res = _run(cfg, ckpt, "--device", "cpu", "--show-dir", str(show))
    assert res.returncode == 0, res.stderr[-2000:]
    res0 = _run(cfg, "--device", "cpu", "--show-dir", str(root / "show0"))
    assert res0.returncode == 0, res0.stderr[-2000:]
    d = np.load(show / "left" / "a" / "0000.disp.pred.npz")["disp"]
    d0 = np.load(root / "show0" / "left" / "a" / "0000.disp.pred.npz")["disp"]
    assert d.shape == d0.shape == (2, 64, 128) and np.isfinite(d).all()
    assert np.abs(d - d0).max() > 1e-3
    from codd_torch.data.datasets import build_test_dataset
    from codd_torch.apis.inference import _predict_disparities, _to_batch
    ds = build_test_dataset(load_config(cfg)["data"]["test"])
    np.testing.assert_array_equal(
        _predict_disparities(model, _to_batch(ds[0], "cpu")), d)
    # a checkpoint of another model must not load
    other = build_estimator(
        load_config(str(ROOT / "configs/models/stereo_motion.py"))["model"],
        device="cpu", seed=None)
    with pytest.raises(RuntimeError):
        load_checkpoint(other, ckpt)


def test_cli_img_dir_mode(tiny_env):
    root, cfg = tiny_env
    show = root / "show_dir_mode"
    res = _run(cfg, "--device", "cpu", "--img-dir", str(root / "left"),
               "--show-dir", str(show))
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(str(p.relative_to(show)) for p in
                  show.rglob("*.disp.pred.npz")) == [
        "a/0000.disp.pred.npz", "b/0000.disp.pred.npz"]
    assert not list((root / "left").rglob("*.npz"))


def test_cli_needs_a_card_without_device_cpu(tiny_env):
    _, cfg = tiny_env
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(cfg, "--eval")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "Summary" not in res.stdout


def test_cli_bf16_is_f32_compute_on_bf16_rounded_weights(tiny_env):
    """``--bf16`` as ``inference.py --bf16``: the weights rounded to bf16,
    the frames and the compute f32.  Its metrics equal, bit for bit, those
    of a checkpoint whose weights were rounded by hand, and differ from
    the f32 weights'."""
    root, cfg = tiny_env
    model = build_estimator(load_config(cfg)["model"], device="cpu", seed=0)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16).to(t.dtype))
    ckpt = save_checkpoint(model, str(root / "w16" / "model.pt"))
    rows = {}
    for name, extra in (("bf16", ["--bf16"]), ("rounded", [ckpt]),
                        ("f32", [])):
        out_csv = str(root / f"m_{name}.csv")
        res = _run(cfg, *extra, "--device", "cpu", "--eval", "--out-csv",
                   out_csv)
        assert res.returncode == 0, res.stderr[-2000:]
        assert res.stdout.count("Summary:") == 2
        rows[name] = list(csv.reader(open(out_csv)))
    assert rows["bf16"] == rows["rounded"]
    assert rows["bf16"][-1] != rows["f32"][-1]
    vals = [float(v) for r in rows["bf16"][1:] for v in r[1:]]
    assert all(np.isfinite(vals))
