"""The port's training entry, ``codd_torch.apis.train.train_estimator`` and
``python -m codd_torch.tools.train``, against ``codd_tpu``'s on a tiny
synthetic stereo-video dataset (64x128, 2 sequences x 3 frames, the
stereo-only model): both start from the same JAX-initialised weights
(``--load-from``: an orbax checkpoint for ``codd_tpu``, the
``torch_state_dict_from_jax`` state written as the port's checkpoint for
the port) and train 2 steps on equal batches.  Then resume, weights-only
loading, validation rows, the CLI on the CPU and the bf16 raise.  One
module-scoped ``codd_tpu`` run is shared."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the tests import both frameworks)

from codd_torch.apis import train as tapi
from codd_torch.config import load_config
from codd_torch.data.io import write_pfm
from codd_torch.train import checkpoint as tckpt

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 128


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import imageio.v2 as imageio
    root = tmp_path_factory.mktemp("entry")
    rng = np.random.RandomState(0)
    lines = []
    for seq in ("a", "b"):
        for i in range(3):
            for side in ("left", "right"):
                os.makedirs(root / side / seq, exist_ok=True)
                imageio.imwrite(str(root / side / seq / f"{i:04d}.png"),
                                (rng.rand(H, W, 3) * 255).astype(np.uint8))
            for kind, shape, lo, hi in (("disp", (H, W), 2, 40),
                                        ("flow", (H, W, 3), -2, 2)):
                os.makedirs(root / kind / seq, exist_ok=True)
                write_pfm(str(root / kind / seq / f"{i:04d}.pfm"),
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
    stereo=dict(type="HITNetMF", initialization=dict(max_disp=64),
                loss=dict(type="HITLoss", max_disp=64)),
    motion=None,
    fusion=None,
    train_cfg=dict(),
)
data = dict(
    train=dict(preset="scene_flow", split=r"{split}", data_root=r"{root}",
               num_frames=2, batch_size=2, disp_range=(1.0, 210.0),
               calib=1050, intrinsics=[100, 100, 64, 32],
               augment=dict(crop_size=({H}, {W}), photometric=True,
                            asym=True)),
    val=dict(preset="scene_flow", split=r"{split}", data_root=r"{root}",
             num_frames=-1, disp_range=(1.0, 210.0), calib=1050,
             intrinsics=[100, 100, 64, 32], pad_divisor=64),
)
schedule = dict(kind="constant", base_lr=1e-4, total_steps=2, grad_clip=1.0)
runtime = dict(log_interval=1, seed=0)
checkpoint = dict(interval=1)
""")
    return str(cfg_file), root


def _rows(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _step_rows(work):
    return {r["step"]: r for r in _rows(work) if "loss" in r}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def jax_run(env):
    """codd_tpu's train_estimator, 2 steps from JAX-initialised weights
    (an orbax checkpoint); the batches it trains on and its rows."""
    import jax.numpy as jnp
    from codd_tpu.apis import train as japi
    from codd_tpu.config import load_config as jax_load_config
    from codd_tpu.models.builder import build_estimator as jax_build
    from codd_tpu.train.checkpoint import save_checkpoint as jax_save
    from codd_tpu.train.optim import make_optimizer as jax_opt
    from codd_tpu.train.trainer import create_train_state as jax_state
    cfg_file, root = env
    cfg = jax_load_config(cfg_file)
    z = jnp.zeros((2, 2, H, W, 3))
    params = jax.jit(jax_build(cfg["model"]).init)(
        jax.random.PRNGKey(0), z, z, jnp.zeros((2, 4)))
    init = str(root / "jax_init")
    jax_save(init, jax_state(params, jax_opt(lambda s: 1e-4)))
    seen = []
    real = japi._device_batch

    def keep(batch):
        seen.append({k: np.array(v) for k, v in batch.items()
                     if k != "meta"})
        return real(batch)

    work = str(root / "jax_work")
    real_mesh = japi.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "_device_batch", keep)
        # one device, as the port: codd_tpu's --load-from puts the params
        # on one device and the batch on a mesh of several (the tests'
        # host has 8), and its step then refuses the mix (ROADMAP Queue 3)
        mp.setattr(japi, "make_mesh", lambda n: real_mesh(1))
        state = japi.train_estimator(cfg, work, load_from=init, max_steps=2,
                                     log=lambda *a: None)
    assert int(state.step) == 2
    # the first batch only shapes codd_tpu's init; steps 1, 2 train on
    # the next two
    return {"params": params, "batches": seen[1:], "rows": _step_rows(work)}


@pytest.fixture(scope="module")
def port_init(env, jax_run):
    """The JAX weights as the port's checkpoint (a ckpt dir at step 0)."""
    from codd_torch.models.builder import build_estimator
    from codd_torch.train.optim import make_optimizer
    from codd_torch.train.trainer import create_train_state
    from codd_torch.utils.params import torch_state_dict_from_jax
    cfg_file, root = env
    model = build_estimator(load_config(cfg_file)["model"], device="cpu",
                            seed=None)
    model.load_state_dict(torch_state_dict_from_jax(jax_run["params"]),
                          strict=True)
    opt = make_optimizer(lambda s: 1e-4)
    return tckpt.save_checkpoint(str(root / "port_init"), model,
                                 create_train_state(model, opt))


def _train(cfg, work, **kw):
    """The port's train_estimator on the CPU; the batches it trains on."""
    seen = []
    real = tapi.to_device

    def keep(batch, device):
        seen.append({k: np.array(v) for k, v in batch.items()
                     if k != "meta"})
        return real(batch, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "to_device", keep)
        state, step = tapi.train_estimator(cfg, str(work), device="cpu",
                                           log=lambda *a: None, **kw)
    return state, step, seen


@pytest.fixture(scope="module")
def port_run(env, port_init):
    """2 steps from the JAX weights, a checkpoint a step, validation at
    step 2."""
    cfg_file, root = env
    cfg = load_config(cfg_file, ["evaluation.interval=2"])
    work = root / "port_work"
    state, step, seen = _train(cfg, work, load_from=port_init, max_steps=2)
    return {"state": state, "step": step, "batches": seen, "work": work,
            "cfg": cfg}


def test_batches_equal_codd_tpu(jax_run, port_run):
    """Dataset -> crop -> photometric (asym) -> normalize -> collate ->
    batch order: the port's batches are codd_tpu's, bit for bit."""
    assert len(port_run["batches"]) == len(jax_run["batches"]) == 2
    for got, want in zip(port_run["batches"], jax_run["batches"]):
        assert sorted(got) == sorted(want) == [
            "gt_disp", "gt_flow", "intrinsics", "l_img", "r_img"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_steps_match_codd_tpu(jax_run, port_run):
    """Step 1 at the tolerances of test_train_step_matches_codd_tpu.  Step
    2 runs on weights that already differ: Adam's first update is about
    lr * sign(g) (1e-4 here), so an element whose gradient is f32 noise
    in both frameworks moves by 1e-4 one way in one and the other way in
    the other; step 2's loss and gradient norm carry that, and are held
    to 1e-3 relative (they read 1.1e-4 and 6.5e-5)."""
    port, jax_rows = _step_rows(port_run["work"]), jax_run["rows"]
    assert port_run["step"] == 2 and port_run["state"].opt_state.count == 2
    assert sorted(port) == sorted(jax_rows) == [1, 2]
    assert _rel(port[1]["loss"], jax_rows[1]["loss"]) < 1e-5
    assert _rel(port[1]["grad_norm"], jax_rows[1]["grad_norm"]) < 1e-4
    assert _rel(port[2]["loss"], jax_rows[2]["loss"]) < 1e-3
    assert _rel(port[2]["grad_norm"], jax_rows[2]["grad_norm"]) < 1e-3
    for s in (1, 2):
        assert port[s]["lr"] == jax_rows[s]["lr"]
        assert port[s]["step_skipped"] == jax_rows[s]["step_skipped"] == 0
        assert port[s]["data_wait_ms"] >= 0 and port[s]["step_ms"] > 0


def test_validation_rows(port_run):
    """evaluation.interval = 2: one validation, at step 2, over the two
    whole sequences, as val/* rows."""
    val = [r for r in _rows(port_run["work"]) if any(
        k.startswith("val/") for k in r)]
    assert len(val) == 1 and val[0]["step"] == 2
    assert {"val/epe", "val/th3", "val/tepe", "val/ms",
            "val/count"} <= set(val[0])
    assert all(np.isfinite(v) for v in val[0].values())


def test_checkpoint_round_trip(port_run):
    """ckpt_2 holds the state as it was saved, bit for bit."""
    state = port_run["state"]
    blob = torch.load(port_run["work"] / "ckpt_2" / tckpt.STATE_FILE,
                      weights_only=True)
    assert blob["step"] == blob["opt_state"]["count"] == 2
    for k, p in state.params.items():
        assert torch.equal(blob["params"][k], p.detach()), k
    for part in ("mu", "nu"):
        tree = getattr(state.opt_state, part)
        assert sorted(blob["opt_state"][part]) == sorted(tree)
        for k, v in tree.items():
            assert torch.equal(blob["opt_state"][part][k], v), (part, k)
    meta = json.loads((port_run["work"] / "ckpt_2" / "meta.json").read_text())
    assert meta["step"] == 2


def test_resume_is_exact(port_run, tmp_path):
    """Resume from ckpt_1, then step 2: the batch, the logs and the saved
    state equal the uninterrupted run's step 2 in bits."""
    work = port_run["work"]
    state, step, seen = _train(port_run["cfg"], tmp_path / "resumed",
                               resume_from=str(work / "ckpt_1"), max_steps=2)
    assert step == 2 and state.opt_state.count == 2
    assert len(seen) == 1
    for k, v in port_run["batches"][1].items():
        assert np.array_equal(seen[0][k], v), k
    got = _step_rows(tmp_path / "resumed")
    assert sorted(got) == [2]
    want = _step_rows(work)[2]
    for k in ("loss", "grad_norm", "lr"):
        assert got[2][k] == want[k], k
    a = torch.load(tmp_path / "resumed" / "ckpt_2" / tckpt.STATE_FILE,
                   weights_only=True)
    b = torch.load(work / "ckpt_2" / tckpt.STATE_FILE, weights_only=True)
    assert a["data"] == b["data"]
    for k in b["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for part in ("mu", "nu"):
        for k in b["opt_state"][part]:
            assert torch.equal(a["opt_state"][part][k],
                               b["opt_state"][part][k]), (part, k)


def test_load_from_restores_params_only(port_run, tmp_path):
    """--load-from ckpt_1: the weights of ckpt_1, a fresh optimizer (the
    run takes its step 1, Adam's count 1) and a fresh data stream."""
    work = port_run["work"]
    blob = torch.load(work / "ckpt_1" / tckpt.STATE_FILE, weights_only=True)
    cfg = dict(port_run["cfg"], evaluation={"interval": 0})
    from codd_torch.models.builder import build_estimator
    model = build_estimator(cfg["model"], device="cpu", seed=None)
    tckpt.restore_params(str(work / "ckpt_1"), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, blob["params"][k]), k
    state, step, seen = _train(cfg, tmp_path / "loaded",
                               load_from=str(work / "ckpt_1"), max_steps=1)
    assert step == 1 and state.opt_state.count == 1
    for k, v in port_run["batches"][0].items():
        assert np.array_equal(seen[0][k], v), k
    assert sorted(_step_rows(tmp_path / "loaded")) == [1]


def test_checkpoint_key_mismatch_raises(port_run, tmp_path):
    from codd_torch.models.builder import build_estimator
    blob = torch.load(port_run["work"] / "ckpt_1" / tckpt.STATE_FILE,
                      weights_only=True)
    model = build_estimator(port_run["cfg"]["model"], device="cpu",
                            seed=None)
    params = dict(blob["params"])
    params.pop(sorted(params)[0])
    for name, bad, match in (
            ("extra", dict(blob["params"], stray=torch.zeros(1)), "stray"),
            ("missing", params, "missing")):
        (tmp_path / name).mkdir()
        torch.save(dict(blob, params=bad), tmp_path / name / tckpt.STATE_FILE)
        with pytest.raises(KeyError, match=match):
            tckpt.restore_params(str(tmp_path / name), model)


def test_bf16_compute_raises_before_a_step(env, tmp_path):
    """``runtime.bf16_compute=True`` no longer raises before a step: one
    step on the CPU logs codd_tpu's bf16 line, writes its row and a
    checkpoint of f32 master parameters and f32 Adam moments that reloads
    into a fresh model in bits."""
    cfg_file, _ = env
    cfg = load_config(cfg_file, ["runtime.bf16_compute=True",
                                 "evaluation.interval=0"])
    lines = []
    work = tmp_path / "bf16"
    state, step = tapi.train_estimator(cfg, str(work), device="cpu",
                                       max_steps=1, log=lines.append)
    assert "bf16 compute enabled (f32 master params)" in lines
    assert step == 1 and state.opt_state.count == 1
    row = _step_rows(work)[1]
    assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
    assert row["step_skipped"] == 0
    blob = torch.load(work / "ckpt_1" / tckpt.STATE_FILE, weights_only=True)
    assert blob["params"] and all(v.dtype == torch.float32
                                  for v in blob["params"].values())
    for part in ("mu", "nu"):
        assert all(v.dtype == torch.float32
                   for v in blob["opt_state"][part].values())
    for k, p in state.params.items():
        assert p.dtype == torch.float32
        assert torch.equal(blob["params"][k], p.detach()), k
    from codd_torch.models.builder import build_estimator
    model = build_estimator(cfg["model"], device="cpu", seed=None)
    tckpt.restore_params(str(work / "ckpt_1"), model)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), state.params[k].detach()), k


def test_cli_trains_on_the_cpu(env, tmp_path):
    """python -m codd_torch.tools.train --device cpu --max-steps 1; without
    --device cpu (and without a card) it exits 1 with the CUDA message."""
    cfg_file, _ = env
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "codd_torch.tools.train", cfg_file, *a],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                 OMP_NUM_THREADS="1"))
    work = tmp_path / "cli"
    out = run("--device", "cpu", "--max-steps", "1", "--work-dir", str(work),
              "--options", "evaluation.interval=0")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step 1/1 loss=" in out.stdout
    assert (work / "ckpt_1" / tckpt.STATE_FILE).exists()
    assert sorted(_step_rows(work)) == [1]
    # the inference CLI reads a training checkpoint's directory
    from codd_torch.tools import inference
    assert inference.main([cfg_file, str(work / "ckpt_1"), "--device", "cpu",
                           "--eval", "--split", "val"]) == 0
    out = run("--max-steps", "1", "--work-dir", str(tmp_path / "cuda"))
    assert out.returncode == 1 and "CUDA is not available" in out.stderr
