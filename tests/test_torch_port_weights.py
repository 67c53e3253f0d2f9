"""Reference CODD checkpoints: ``codd_torch.utils.port_weights`` against
``codd_tpu.utils.port_weights`` on a synthetic reference state_dict.

The state_dict is built from the shapes of ``codd_tpu``'s
``CODD(max_disp=64, iters=2).init`` (``jax.eval_shape``, no compile) under
the reference names of ``codd_tpu``'s tables, in the reference layouts
(conv (O, I, kh, kw), ConvTranspose (I, O, kh, kw), BatchNorm
weight / bias / running_mean / running_var / num_batches_tracked), with no
bias where the flax module has none (the HRNet cnet's convs), plus the
HITLoss plane-fit convs.  The port's conversion must equal
``torch_state_dict_from_jax`` applied to ``codd_tpu``'s in bits, report
the same missing prefixes, load strictly into the port's model, and give
``codd_tpu``'s frame 0 on the converted weights.
"""

import numpy as np
import pytest

import jax
import torch

from codd_tpu.models.codd import CODD as JCODD
from codd_tpu.utils import port_weights as jpw
from codd_torch.models.codd import CODD as TCODD
from codd_torch.utils import port_weights as tpw
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

H, W = 64, 128
SUBMODULES = (("stereo", jpw.HITNET_MAP, ("stereo",)),
              ("motion.raft3d", jpw.RAFT3D_MAP, ("motion", "raft3d")),
              ("fusion", jpw.FUSION_MAP, ("fusion",)))


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.fixture(scope="module")
def shapes():
    rng = np.random.RandomState(0)
    left = rng.rand(1, 2, H, W, 3).astype(np.float32)
    intr = np.array([[100.0, 100.0, W / 2, H / 2]], np.float32)
    v = jax.eval_shape(lambda k: JCODD(max_disp=64, iters=2).init(
        k, left, left, intr), jax.random.PRNGKey(0))
    to_dict = lambda t: {k: to_dict(x) if hasattr(x, "items") else x.shape
                         for k, x in t.items()}
    return {col: to_dict(v[col]) for col in ("params", "batch_stats")}


def reference_state_dict(shapes, seed=0):
    """A complete reference estimator state_dict over ``shapes``."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    sd = {}
    for sub, table, dest in SUBMODULES:
        for entry in table:
            prefix, path = f"{sub}.{entry[0]}", dest + tuple(
                entry[1].split("/"))
            kind = entry[2] if len(entry) > 2 else "conv"
            if kind == "bn":
                (c,) = _node(shapes["params"], path)["scale"]
                sd[f"{prefix}.weight"] = t(1 + 0.1 * rng.randn(c))
                sd[f"{prefix}.bias"] = t(0.1 * rng.randn(c))
                sd[f"{prefix}.running_mean"] = t(0.1 * rng.randn(c))
                sd[f"{prefix}.running_var"] = t(rng.uniform(0.5, 1.5, c))
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)
                continue
            node = _node(shapes["params"], path)
            kh, kw, i, o = node["kernel"]
            shape = (i, o, kh, kw) if kind == "deconv" else (o, i, kh, kw)
            sd[f"{prefix}.weight"] = t(rng.randn(*shape)
                                       / np.sqrt(i * kh * kw))
            if "bias" in node:
                sd[f"{prefix}.bias"] = t(0.01 * rng.randn(o))
    # the HITLoss plane-fit kernels, as a trained checkpoint carries them
    for name in ("convx", "convy"):
        sd[f"stereo.loss.{name}.weight"] = t(rng.randn(1, 1, 9, 9))
    return sd


@pytest.fixture(scope="module")
def converted(shapes):
    sd = reference_state_dict(shapes)
    return sd, jpw.port_codd_checkpoint(sd), tpw.port_codd_checkpoint(
        {"meta": {"epoch": 3}, "state_dict": sd})


def test_tables_equal_codd_tpu():
    assert tpw.HITNET_MAP == jpw.HITNET_MAP
    assert tpw.RAFT3D_MAP == jpw.RAFT3D_MAP
    assert tpw.FUSION_MAP == jpw.FUSION_MAP


def test_tables_reach_every_leaf(shapes, converted):
    """codd_tpu's tables fill every params and batch_stats leaf of the
    model: a complete reference state_dict leaves nothing at its init."""
    _, j, t = converted
    for col in ("params", "batch_stats"):
        assert set(_leaves(j[col])) == set(_leaves(shapes[col])), col
    assert j["missing"] == t["missing"] == []


def test_equals_codd_tpu_composed(converted):
    """The rename equals torch_state_dict_from_jax after codd_tpu's
    conversion, every tensor in bits (dtype f32, on the CPU)."""
    sd, j, t = converted
    want = torch_state_dict_from_jax(
        {"params": j["params"], "batch_stats": j["batch_stats"]})
    got = t["state_dict"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert got[k].shape == v.shape and torch.equal(got[k], v), k
    assert set(t["hit_loss_kernels"]) == {"convx", "convy"}
    for k in ("convx", "convy"):
        assert t["hit_loss_kernels"][k].shape == (9, 9)
        np.testing.assert_array_equal(t["hit_loss_kernels"][k],
                                      j["hit_loss_kernels"][k])
    # a rename: the reference's own tensors pass through as they are
    assert torch.equal(got["stereo.backbone.up1.conv.weight"],
                       sd["stereo.backbone.up1.0.weight"])


def test_loads_strictly(converted):
    model = TCODD(max_disp=64, iters=2)
    model.load_state_dict(converted[2]["state_dict"], strict=True)


@pytest.mark.parametrize("parts", [("stereo",), ("stereo", "motion")])
def test_partial_checkpoint_loads_strictly(converted, parts):
    """A stereo-only and a stereo + motion checkpoint load strictly into
    the model without the parts they lack, and report those parts'
    prefixes as missing, as codd_tpu does."""
    sd = {k: v for k, v in converted[0].items() if k.split(".")[0] in parts}
    t, j = tpw.port_codd_checkpoint(sd), jpw.port_codd_checkpoint(sd)
    assert t["missing"] == j["missing"]
    assert {m.split(".")[0] for m in t["missing"]} == (
        {"motion", "fusion"} - set(parts))
    model = TCODD(max_disp=64, iters=2,
                  motion_type="Motion" if "motion" in parts else "none",
                  fusion_type="none")
    model.load_state_dict(t["state_dict"], strict=True)


def test_missing_matches_codd_tpu(converted):
    """A stereo-only state_dict with one conv dropped: the same missing
    prefixes, in codd_tpu's order and spelling."""
    sd = {k: v for k, v in converted[0].items() if k.startswith("stereo.")
          and not k.startswith("stereo.tile_update.tile_update2.conv0.0.")}
    t, j = tpw.port_codd_checkpoint(sd), jpw.port_codd_checkpoint(sd)
    assert "stereo.tile_update.tile_update2.conv0.0" in t["missing"]
    assert t["missing"] == j["missing"]
    assert len(t["missing"]) == len(tpw.RAFT3D_MAP) + len(tpw.FUSION_MAP) + 1


def test_first_step_matches_codd_tpu(converted):
    """Frame 0 at 64x128 on the converted weights: the port (plain
    versions on the CPU) against codd_tpu on codd_tpu's conversion, at
    tests/test_torch_codd.py's tolerances."""
    _, j, t = converted
    rng = np.random.RandomState(1)
    left, right = (rng.rand(1, H, W, 3).astype(np.float32) for _ in range(2))
    intr = np.array([[100.0, 100.0, W / 2, H / 2]], np.float32)
    jm = JCODD(max_disp=64, iters=2)
    variables = {"params": j["params"], "batch_stats": j["batch_stats"]}
    carry, out = jax.jit(lambda v, l, r, i: jm.apply(
        v, l, r, i, method=JCODD.first_step))(variables, left, right, intr)
    tm = TCODD(max_disp=64, iters=2).eval()
    tm.load_state_dict(t["state_dict"], strict=True)
    with torch.no_grad():
        tcarry, tout = tm.first_step(*(torch.from_numpy(a) for a in
                                       (left, right, intr)))
    rel = lambda a, b: (np.abs(np.asarray(a) - np.asarray(b)).max()
                        / (np.abs(np.asarray(b)).max() + 1e-12))
    for k in ("pred_disp", "left_feat", "right_feat", "left_img"):
        assert tout[k].shape == out[k].shape, k
        assert np.isfinite(np.asarray(out[k])).all(), k
        assert rel(tout[k].numpy(), out[k]) < 1e-5, k
    for k in ("memory_img", "memory_feat", "memory_disp", "fmap", "netinp"):
        assert rel(getattr(tcarry, k).numpy(), getattr(carry, k)) < 1e-5, k
