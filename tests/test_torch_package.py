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

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "configs" / "models" / "codd.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "codd_tpu")


def _port_files():
    files = sorted((ROOT / "codd_torch").rglob("*.py"))
    names = {str(f.relative_to(ROOT / "codd_torch")) for f in files}
    # the scan must reach every subpackage of the port
    assert {"apis/evaluation.py", "apis/inference.py", "data/datasets.py",
            "data/io.py", "tools/inference.py", "utils/checkpoint.py",
            "models/motion/others.py", "models/fusion/others.py",
            "ops/metrics.py", "utils/masks.py", "apis/train.py",
            "data/loader.py", "data/native.py", "data/pipelines.py",
            "data/transforms.py", "train/checkpoint.py", "utils/logging.py",
            "tools/train.py", "utils/port_weights.py",
            "utils/generate_split_files.py",
            "utils/vis_point_cloud.py", "parallel/mesh.py"} <= names, names
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


def _cfg(name="codd.py", **over):
    return dict(load_config(str(ROOT / "configs" / "models" / name))["model"],
                **over)


@pytest.mark.parametrize("runtime", [
    {"gn_impl": "fused"},
    {"gn_impl": "pallas_window", "gn_bf16_scores": True},
    {"gn_impl": "windowed"},
    {"gn_impl": "dense"},
    {"tile_warp_variant": "pallas"},
    {"tile_warp_variant": "tilewin", "init_cost_variant": "phases"},
    {"corr_impl": "patch"},
    {"corr_impl": "volume_pallas"},
    {"splat_impl": "pallas", "splat_impl_lr": "xla_window",
     "splat_impl_train": "xla_sort_window"},
    {"pixel_center_offset": -0.5, "gn_unroll": 4},
])
def test_runtime_knobs_are_strict(runtime):
    """Every value codd_tpu accepts builds, in both packages."""
    from codd_tpu.models.builder import build_estimator as jax_build
    cfg = _cfg(runtime=runtime)
    jm = jax_build(cfg)
    tm = build_estimator(cfg, device="cpu", seed=None)
    raft = tm.motion.raft3d
    assert raft.gn_iter.gn_impl == jm.gn_impl
    assert raft.gn_iter.gn_bf16_scores == jm.gn_bf16_scores
    assert raft.pyramid_impl == ("patch" if jm.corr_impl == "patch"
                                 else "volume")
    assert tm.motion.pixel_center_offset == jm.pixel_center_offset
    # validated only: no training path reads it yet
    assert not hasattr(tm, "splat_impl_train")


@pytest.mark.parametrize("runtime", [
    {"gn_impll": "auto"},            # unknown key
    {"gn_impl": "flash"},            # unknown values
    {"corr_impl": "volumes"},
    {"tile_warp_variant": "fast"},
    {"init_cost_variant": "x"},
    {"splat_impl": "cuda"},
    {"splat_impl_train": ""},
    {"gn_unroll": 0},
    {"gn_bf16_scores": "yes"},
    {"pixel_center_offset": "half"},
])
def test_runtime_unknown_key_or_value_raises(runtime):
    with pytest.raises(ValueError):
        build_estimator(_cfg(runtime=runtime), device="cpu", seed=None)


@pytest.mark.parametrize("over,mtype,ftype", [
    ({"runtime": dict(RUNTIME_DEFAULTS)}, "Motion", "Fusion"),
    ({"motion": {"type": "GTMotion"}}, "GTMotion", "Fusion"),
    ({"fusion": {"type": "KalmanFusion"}}, "Motion", "KalmanFusion"),
    ({"fusion": {"type": "GTFusion"}, "motion": {"type": "GTMotion"}},
     "GTMotion", "GTFusion"),
    ({"fusion": {"type": "NullFusion"}}, "Motion", "NullFusion"),
    ({"fusion": None}, "Motion", "none"),
    ({"motion": None, "fusion": None}, "none", "none"),
])
def test_defaults_and_other_types(over, mtype, ftype):
    model = build_estimator(_cfg(**over), device="cpu", seed=None)
    assert (model.motion_type, model.fusion_type) == (mtype, ftype)
    assert hasattr(model, "motion") == (mtype == "Motion")
    assert hasattr(model, "fusion") == (ftype == "Fusion")


def test_unknown_types_raise():
    for over in ({"motion": {"type": "RAFT"}}, {"fusion": {"type": "Mean"}}):
        with pytest.raises(ValueError):
            build_estimator(_cfg(**over), device="cpu", seed=None)


@pytest.mark.parametrize("name,mtype,ftype", [
    ("codd.py", "Motion", "Fusion"), ("stereo.py", "none", "none"),
    ("stereo_motion.py", "Motion", "none")])
def test_model_configs_build_like_codd_tpu(name, mtype, ftype):
    from codd_tpu.models.builder import build_estimator as jax_build
    cfg = _cfg(name)
    jm = jax_build(cfg)
    tm = build_estimator(cfg, device="cpu", seed=None)
    assert (tm.motion_type, tm.fusion_type) == (mtype, ftype)
    assert (jm.motion_type, jm.fusion_type) == (mtype, ftype)
    assert tm.stereo.tile_init.max_disp == jm.max_disp == 320
    for flag in ("freeze_stereo", "freeze_motion", "freeze_fusion"):
        assert getattr(tm, flag) == getattr(jm, flag), flag


def test_kernel_library_key_covers_headers(tmp_path, monkeypatch):
    """A change to a shared header must change the built library's name."""
    from codd_torch.ops import kernels
    src = tmp_path / "k.cu"
    src.write_text('#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// a\n")
    before = kernels._lib_path(src)
    assert kernels._lib_path(src) == before
    (tmp_path / "c.cuh").write_text("// b\n")
    assert kernels._lib_path(src) != before
    assert {"gn_window_aggregate", "corr_patch_lookup"} <= set(kernels.KERNELS)
    for name, (source, _, _) in kernels.KERNELS.items():
        assert (kernels.CSRC / source).exists(), name


@pytest.mark.parametrize("name", ["models/codd.py", "inference_config.py",
                                  "training_config.py"])
def test_config_loader_matches_codd_tpu(name):
    path = str(ROOT / "configs" / name)
    opts = ["model.motion.iters=4", "data.tag=x"]
    assert dict(load_config(path, opts)) == dict(jax_load_config(path, opts))


@pytest.fixture(scope="module")
def jax_variable_shapes():
    """Variable trees of the three model kinds, by shape only
    (``jax.eval_shape``: no compile), filled with seeded numbers."""
    import jax.numpy as jnp
    import numpy as np
    from codd_tpu.models.builder import build_estimator as jax_build
    z = jnp.zeros((1, 2, 64, 128, 3))
    intr = jnp.zeros((1, 4))
    rng = np.random.RandomState(0)
    out = {}
    for name in ("codd.py", "stereo.py", "stereo_motion.py"):
        jm = jax_build(_cfg(name))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, z, intr)
        out[name] = jax.tree_util.tree_map(
            lambda s: rng.rand(*s.shape).astype(np.float32), shapes)
    return out


@pytest.mark.parametrize("name", ["codd.py", "stereo.py", "stereo_motion.py"])
def test_weights_carry_for_every_model_kind(jax_variable_shapes, name):
    """A stereo-only, a stereo + motion and a full codd_tpu variable tree
    each load strictly into the port's model of the same config (a missing
    motion / fusion subtree is legal exactly when the model has none); a
    tree of another kind does not."""
    import numpy as np
    from codd_torch.utils.params import torch_state_dict_from_jax
    variables = jax_variable_shapes[name]
    tm = build_estimator(_cfg(name), device="cpu", seed=None)
    sd = torch_state_dict_from_jax(variables)
    tm.load_state_dict(sd, strict=True)
    top = {k.split(".")[0] for k in sd}
    assert top == {"stereo"} | ({"motion"} if hasattr(tm, "motion") else set()) \
        | ({"fusion"} if hasattr(tm, "fusion") else set())
    got = tm.state_dict()
    assert all(np.array_equal(got[k].numpy(), v.numpy()) for k, v in sd.items())
    other = "stereo.py" if name != "stereo.py" else "codd.py"
    with pytest.raises(RuntimeError):
        tm.load_state_dict(
            torch_state_dict_from_jax(jax_variable_shapes[other]), strict=True)
