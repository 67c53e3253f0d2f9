"""The sequence evaluator and ``run_inference`` of the port against
codd_tpu's, on the same weights (carried by ``torch_state_dict_from_jax``)
and the same numpy batches.

Tolerances.  The port's stream differs from codd_tpu's on a share of the
pixels downstream of the splat (fragments of equal quantised depth
composite in arbitrary order there; see test_torch_codd.py), so with the
full model the fused disparity, and every metric of it, moves a little:
means of errors (epe, tepe, ...) are held to 0.2 % relative (0.014 % seen),
pixel-counting metrics (th3, th3_tepe, th1_tepe_rel, 1px_*) to a share of
0.005 of the pixels (0.0007 seen), since a pixel near a threshold may fall
on either side.  Metrics
that read only ground truth (flow_mag, count) and every metric of the
stereo-only model (no splat) agree to f32 rounding of a mean over pixels
(rel 1e-4; thresholds to 1e-3 of the pixels).
"""

import csv
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from codd_tpu.apis import inference as jinf
from codd_tpu.apis.evaluation import (METER_NAMES as J_METERS,
                                      SUM_NAMES as J_SUMS,
                                      make_sequence_evaluator as jax_evaluator)
from codd_tpu.apis.train import build_dataset_from_cfg
from codd_tpu.config import load_config as jax_load_config
from codd_tpu.data import io as jio
from codd_tpu.models.builder import build_estimator as jax_build
from codd_tpu.models.codd import CODD as JCODD
from codd_torch.apis import inference as tinf
from codd_torch.apis.evaluation import (METER_NAMES, SUM_NAMES,
                                        make_sequence_evaluator)
from codd_torch.config import load_config
from codd_torch.data.datasets import build_test_dataset
from codd_torch.models.builder import build_estimator
from codd_torch.models.codd import CODD as TCODD
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

B, T, H, W = 1, 3, 64, 128
COUNTING = ("th3", "th3_tepe", "th1_tepe_rel")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(B, T, H, W, 1) > 0.9).astype(np.float32)
    return {
        "l_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]], np.float32),
        "gt_disp": rng.uniform(0.5, 40, (B, T, H, W, 1)).astype(np.float32),
        "gt_flow": rng.uniform(-2, 2, (B, T, H, W, 2)).astype(np.float32),
        "gt_disp_change": rng.uniform(-1, 1, (B, T, H, W, 1)
                                      ).astype(np.float32),
        "gt_flow_occ": occ,
        "gt_disp2": rng.uniform(0.5, 40, (B, T, H, W, 1)).astype(np.float32),
        "gt_disp_occ": (rng.rand(B, T, H, W, 1) > 0.9).astype(np.float32),
    }


def _torch_batch(batch, img_hw, frame_valid):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["img_hw"] = tuple(img_hw)
    out["frame_valid"] = torch.tensor(frame_valid)
    return out


def _jax_batch(batch, img_hw, frame_valid):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["img_hw"] = jnp.asarray(img_hw, jnp.int32)
    out["frame_valid"] = jnp.asarray(frame_valid)
    return out


def test_metric_names_match():
    assert METER_NAMES == J_METERS and SUM_NAMES == J_SUMS
    assert tinf.GT_KEYS == jinf.GT_KEYS


@pytest.fixture(scope="module")
def evaluators():
    """One jitted codd_tpu evaluator per flag set, the port's beside it,
    same weights: CODD(max_disp=64, iters=1) as tests/test_evaluation.py."""
    batch = _batch()
    jm = JCODD(max_disp=64, iters=1)
    variables = jax.jit(lambda k: jm.init(
        k, batch["l_img"][:, :2], batch["r_img"][:, :2],
        batch["intrinsics"]))(jax.random.PRNGKey(0))
    tm = TCODD(max_disp=64, iters=1).eval()
    tm.load_state_dict(torch_state_dict_from_jax(_np(variables)), strict=True)
    flags = {
        "all": dict(has_disp2=True, has_flow_occ=True, has_disp_change=True,
                    has_disp_occ=True),
        "occ": dict(has_flow_occ=True),
    }
    return {name: (jax_evaluator(jm, **kw), make_sequence_evaluator(tm, **kw),
                   variables) for name, kw in flags.items()}, batch


def _compare(got, ref, npix_meter, full_model=True):
    count = max(ref["count"], 1.0)
    for k in METER_NAMES + SUM_NAMES:
        g, r = float(got[k]), float(ref[k])
        assert np.isfinite(g), k
        if k in ("flow_mag", "count"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=k)
        elif k in COUNTING:
            assert abs(g - r) <= (5e-3 if full_model else 1e-3), (k, g, r)
        elif k.startswith("1px"):
            assert abs(g - r) / count <= (5e-3 if full_model else 1e-3), \
                (k, g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=2e-3 if full_model else 1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("flags,img_hw,frame_valid", [
    ("all", (H, W), [True, True, True]),
    ("all", (60, 120), [True, True, False]),   # padded frame, cropped extent
    ("occ", (H, W), [True, True, True]),
    ("occ", (50, 100), [True, True, True]),
])
def test_sequence_evaluator_matches(evaluators, flags, img_hw, frame_valid):
    evs, batch = evaluators
    jev, tev, variables = evs[flags]
    if flags == "occ":  # the dataset has no disp_change / disp2 / disp_occ
        batch = {k: v for k, v in batch.items()
                 if k not in ("gt_disp_change", "gt_disp2", "gt_disp_occ")}
    ref = {k: float(v) for k, v in
           _np(jev(variables, _jax_batch(batch, img_hw, frame_valid))).items()}
    got = tev(_torch_batch(batch, img_hw, frame_valid))
    assert set(got) == set(ref) == set(METER_NAMES + SUM_NAMES)
    assert ref["count"] > 0 and ref["epe"] > 0 and ref["tepe"] > 0
    _compare(got, ref, img_hw[0] * img_hw[1])


def test_padded_frame_and_crop_change_the_meters(evaluators):
    """frame_valid and img_hw are honoured: a padded last frame halves the
    scene-flow count, a smaller extent shrinks it by the area ratio."""
    evs, batch = evaluators
    _, tev, _ = evs["all"]
    full = tev(_torch_batch(batch, (H, W), [True, True, True]))
    padded = tev(_torch_batch(batch, (H, W), [True, True, False]))
    cropped = tev(_torch_batch(batch, (H // 2, W), [True, True, True]))
    assert 0 < padded["count"] < full["count"]
    assert 0.4 < cropped["count"] / full["count"] < 0.6
    assert padded["epe"] != full["epe"]


# ---------------------------------------------------------------------------
# the slice as a whole: run_inference on a generated on-disk dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    """Two 3-frame 60x120 sequences (padded to 64x128 by the pipeline):
    PNG images, PFM disparity and flow, a split file and a stereo-only
    config, as tests/test_e2e_train_infer.py writes them."""
    import imageio.v2 as imageio
    root = tmp_path_factory.mktemp("tiny")
    rng = np.random.RandomState(0)
    h, w = 60, 120
    lines = []
    for seq in ("a", "b"):
        for i in range(3):
            for side in ("left", "right"):
                d = root / side / seq
                os.makedirs(d, exist_ok=True)
                imageio.imwrite(str(d / f"{i:04d}.png"),
                                (rng.rand(h, w, 3) * 255).astype(np.uint8))
            for kind, shape, lo, hi in (("disp", (h, w), 2, 40),
                                        ("flow", (h, w, 3), -2, 2)):
                d = root / kind / seq
                os.makedirs(d, exist_ok=True)
                jio.write_pfm(str(d / f"{i:04d}.pfm"),
                              rng.uniform(lo, hi, shape).astype(np.float32))
            lines.append(" ".join([
                f"left/{seq}/{i:04d}.png", f"right/{seq}/{i:04d}.png",
                f"disp/{seq}/{i:04d}.pfm", f"flow/{seq}/{i:04d}.pfm"]))
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    cfg_file = root / "cfg.py"
    cfg_file.write_text(f"""
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
    return str(cfg_file), str(root)


@pytest.fixture(scope="module")
def both_models(tiny_env):
    cfg_file, _ = tiny_env
    jcfg = jax_load_config(cfg_file)
    tcfg = load_config(cfg_file)
    assert dict(jcfg) == dict(tcfg)
    jm = jax_build(jcfg["model"])
    z = jnp.zeros((1, 2, 64, 128, 3))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), z, z,
                                 jnp.asarray([[100.0, 100.0, 64.0, 32.0]]))
    tm = build_estimator(tcfg["model"], device="cpu", seed=None)
    tm.load_state_dict(torch_state_dict_from_jax(_np(variables)), strict=True)
    return jm, variables, tm, jcfg, tcfg


def test_run_inference_matches(tiny_env, both_models):
    """Summary dicts and CSV rows of the two run_inference agree
    (stereo-only model: no splat, so f32 rounding only)."""
    _, root = tiny_env
    jm, variables, tm, jcfg, tcfg = both_models
    jds = build_dataset_from_cfg(dict(jcfg["data"]["test"]), train=False)
    tds = build_test_dataset(dict(tcfg["data"]["test"]))
    assert len(jds) == len(tds) == 2
    jcsv, tcsv = os.path.join(root, "j.csv"), os.path.join(root, "t.csv")
    jlog, tlog = [], []
    ref = jinf.run_inference(jm, variables, jds, evaluate=True, out_csv=jcsv,
                             log=jlog.append)
    got = tinf.run_inference(tm, tds, evaluate=True, out_csv=tcsv,
                             log=tlog.append)
    assert set(got) == set(ref)
    assert got["count"] == ref["count"] == 0.0   # no transform field
    _compare(dict({k: 0.0 for k in SUM_NAMES}, **got),
             dict({k: 0.0 for k in SUM_NAMES}, **ref), 60 * 120,
             full_model=False)
    assert [l for l in tlog if l == "Summary:"] == \
        [l for l in jlog if l == "Summary:"]
    jrows, trows = (list(csv.reader(open(p))) for p in (jcsv, tcsv))
    assert trows[0] == jrows[0] == (["filename"] + list(METER_NAMES)
                                    + list(SUM_NAMES))
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert len(trows) == 4 and trows[-1][0] == "mean"
    for tr, jr in zip(trows[1:], jrows[1:]):
        _compare(dict(zip(trows[0][1:], map(float, tr[1:]))),
                 dict(zip(jrows[0][1:], map(float, jr[1:]))), 60 * 120,
                 full_model=False)


def test_show_dir_matches(tiny_env, both_models, tmp_path):
    """--show-dir output: one <name>.disp.pred.npz a sequence, cropped to
    the pre-pad extent; disparities agree to f32 rounding except where the
    stereo argmax flips on a near-tie (share bounded)."""
    jm, variables, tm, jcfg, tcfg = both_models
    jds = build_dataset_from_cfg(dict(jcfg["data"]["test"]), train=False)
    tds = build_test_dataset(dict(tcfg["data"]["test"]))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert jinf.run_inference(jm, variables, jds, show_dir=jdir) == {}
    assert tinf.run_inference(tm, tds, show_dir=tdir) == {}
    for seq in ("a", "b"):
        rel = os.path.join("left", seq, "0000.disp.pred.npz")
        jd = np.load(os.path.join(jdir, rel))["disp"]
        td = np.load(os.path.join(tdir, rel))["disp"]
        assert td.shape == jd.shape == (3, 60, 120)
        off = np.abs(td - jd) > 1e-3 * (1 + np.abs(jd))
        assert off.mean() < 1e-3, off.mean()


def test_summarize_modes_and_table():
    from codd_tpu.utils.running_stats import RunningStatsWithBuffer as JStats
    from codd_torch.utils.running_stats import RunningStatsWithBuffer as TStats
    rng = np.random.RandomState(0)
    rows = rng.rand(3, len(METER_NAMES) + len(SUM_NAMES)) * 10
    for mode in ("default", "disp_only", "motion_only"):
        js, ts, jl, tl = JStats(), TStats(), [], []
        for i, r in enumerate(rows):
            js.push(f"s{i}", r)
            ts.push(f"s{i}", r)
        assert tinf.summarize(ts, mode, tl.append) == \
            jinf.summarize(js, mode, jl.append)
        assert tl == jl and any("+---" in str(l) for l in tl)
    with pytest.raises(KeyError):
        tinf.summarize(TStats(), "everything")
    assert tinf.summarize(TStats(), log=lambda *_: None) == {}
