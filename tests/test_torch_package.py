"""codd_torch package rules: no JAX anywhere in the port or chip_smoke.py,
the device contract of build_estimator, the strict runtime knobs, and the
config loader's parity with codd_tpu's."""

import ast
from pathlib import Path

import pytest

import jax  # noqa: F401  (the tests import both frameworks)
import torch

from codd_tpu.config import load_config as jax_load_config
from codd_torch.config import load_config
from codd_torch.models.builder import RUNTIME_DEFAULTS, build_estimator

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "configs" / "models" / "codd.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "codd_tpu")


def _port_files():
    files = sorted((ROOT / "codd_torch").rglob("*.py"))
    assert len(files) > 15
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax():
    bad = [(str(p.relative_to(ROOT)), name) for p in _port_files()
           for name in _imports(p) if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from codd_tpu.ops import se3\n"
                 "    import flax.linen as nn\n")
    assert [n.split(".")[0] for n in _imports(p)] == ["codd_tpu", "flax"]


def test_build_estimator_needs_cuda_unless_cpu(monkeypatch):
    cfg = load_config(str(CFG))["model"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_estimator(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_estimator(cfg, device="cuda")
    model = build_estimator(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training
    assert model.stereo.tile_init.max_disp == 320
    assert model.motion.raft3d.iters == 16
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("runtime,err", [
    ({"gn_impl": "fused"}, NotImplementedError),
    ({"tile_warp_variant": "pallas"}, NotImplementedError),
    ({"corr_impl": "patch"}, NotImplementedError),
    ({"splat_impl": "pallas"}, NotImplementedError),
    ({"pixel_center_offset": -0.5}, NotImplementedError),
    ({"gn_impll": "auto"}, ValueError),
])
def test_runtime_knobs_are_strict(runtime, err):
    cfg = dict(load_config(str(CFG))["model"])
    cfg["runtime"] = runtime
    with pytest.raises(err):
        build_estimator(cfg, device="cpu", seed=None)


def test_defaults_and_other_types():
    cfg = dict(load_config(str(CFG))["model"])
    cfg["runtime"] = dict(RUNTIME_DEFAULTS)
    build_estimator(cfg, device="cpu", seed=None)
    for key, val in (("motion", {"type": "GTMotion"}),
                     ("fusion", {"type": "KalmanFusion"}), ("fusion", None)):
        bad = dict(cfg, **{key: val})
        with pytest.raises(NotImplementedError):
            build_estimator(bad, device="cpu", seed=None)


@pytest.mark.parametrize("name", ["models/codd.py", "inference_config.py",
                                  "training_config.py"])
def test_config_loader_matches_codd_tpu(name):
    path = str(ROOT / "configs" / name)
    opts = ["model.motion.iters=4", "data.tag=x"]
    assert dict(load_config(path, opts)) == dict(jax_load_config(path, opts))
