"""Multi-process training and evaluation of the port on the CPU: two gloo
processes (``codd_torch/parallel/mesh.py``) against one process on the
global batch.

* one stereo-stage step (64x128, T=2) with each process holding half of a
  global batch of 2 whose halves' valid-pixel counts differ by more than
  3x, against codd_tpu's ``make_train_step`` on the whole batch in one
  process, with ``accum_steps`` 1 and 2 (microbatch i is global row i, all
  of one process's rows, none of the other's), under SGD so that the
  updated parameters carry the gradients; a per-process mean (each
  process's loss over its own counts, the gradients averaged) misses the
  bound by 10x or more;
* ``_merge_hosts`` as ``tests/test_multihost.py`` drives codd_tpu's;
* ``run_inference`` on 3 sequences sharded over two processes, against
  one process;
* ``python -m torch.distributed.run --nproc_per_node=2 -m
  codd_torch.tools.train --device cpu``: 2 steps, a checkpoint a step, and
  a resume from step 1 that ends in the uninterrupted run's bits.

Every process group has a timeout and every subprocess a ``timeout=``, so
a hang fails one test.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from codd_tpu.models.builder import build_estimator as jbuild
from codd_tpu.models.builder import build_loss_config as jbuild_loss
from codd_tpu.train import trainer as jtrainer
from codd_torch.config import load_config
from codd_torch.data.io import write_pfm
from codd_torch.utils.params import torch_state_dict_from_jax

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, T, H, W = 2, 2, 64, 128
MAXD = 32
LR = 1e-3
RUN_TIMEOUT = 240   # seconds a group of worker processes may take


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG")
           if k in os.environ}
    env.update(PYTHONPATH=str(ROOT), OMP_NUMBER_THREADS="1",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return env


def _run_ranks(script, args, world=2):
    """``script`` in ``world`` processes joined as torchrun would join
    them; returns their outputs, each process's exit code 0."""
    env = _env()
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, str(script)] + [str(a) for a in args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    return outs


# ---------------------------------------------------------------------------
# one stereo-stage step
# ---------------------------------------------------------------------------

_STEP = textwrap.dedent("""
    import sys, datetime
    import numpy as np, torch
    torch.set_num_threads(1)
    from codd_torch.models.builder import build_estimator, build_loss_config
    from codd_torch.losses.assembly import codd_train_loss
    from codd_torch.parallel import mesh
    from codd_torch.train import optim, trainer

    cfg_path, data, out, accum, naive = sys.argv[1:6]
    mesh.init_distributed("cpu", timeout=datetime.timedelta(seconds=120))
    rank, world = mesh.process_index(), mesh.process_count()
    cfg = torch.load(cfg_path, weights_only=False)
    model = build_estimator(cfg["model"], device="cpu", seed=None)
    model.load_state_dict(cfg["state"], strict=True)
    mesh.broadcast_state(model)
    z = np.load(data)
    n = z["l_img"].shape[0] // world
    batch = {k: torch.from_numpy(z[k][rank * n:(rank + 1) * n])
             for k in z.files}
    lr = float(cfg["lr"])

    class Sgd:
        def init(self, params):
            return optim.AdamState(0, {}, {})
        def trained_names(self, tree):
            return list(tree)
        def update(self, grads, state, params=None):
            return {k: -lr * g for k, g in grads.items()}, state

    lc = build_loss_config(cfg["model"])
    if naive == "1":   # each process's mean over its own rows, averaged
        outs = model(batch["l_img"], batch["r_img"], batch["intrinsics"],
                     train=True)
        loss, _ = codd_train_loss(lc, outs, batch)
        loss.backward()
        grads = mesh.all_reduce_grads(dict(model.named_parameters()))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.add_(-lr * grads[k] / world)
        logs = {"loss": mesh.all_reduce_sum(loss.detach()) / world}
    else:
        step = trainer.make_train_step(model, Sgd(), lc,
                                       accum_steps=int(accum))
        _, logs = step(trainer.create_train_state(model, Sgd()), batch)
    if rank == 0:
        torch.save({"params": {k: p.detach() for k, p in
                               model.named_parameters()},
                    "logs": {k: float(v) for k, v in logs.items()}}, out)
    torch.distributed.destroy_process_group()
""")


def _stereo_cfg():
    return dict(load_config(str(ROOT / "configs" / "models" / "stereo.py"), [
        f"model.stereo.initialization.max_disp={MAXD}",
        f"model.stereo.loss.max_disp={MAXD}"])["model"])


def _numpy_params(shapes, seed=1):
    """lecun-normal kernels, unit scales and variances, zero elsewhere."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if "scale" in name or "var" in name:
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _unequal_batch(seed=0):
    """A global batch of 2 clips; the second's ground truth is invalid
    (0) outside its left quarter, so its rows hold well under a third of
    the first's valid pixels."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 25.0, (B, T, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.05] = 0.0
    gt[1, :, :, W // 4:] = 0.0
    return {
        "l_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "r_img": rng.rand(B, T, H, W, 3).astype(np.float32),
        "gt_disp": gt,
        "intrinsics": np.array([[100.0, 100.0, W / 2, H / 2]] * B,
                               np.float32),
    }


@pytest.fixture(scope="module")
def stereo_step(tmp_path_factory):
    """The weights, the batch and the files the processes read."""
    root = tmp_path_factory.mktemp("dist_step")
    cfg = _stereo_cfg()
    batch = _unequal_batch()
    jm = jbuild(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["l_img"],
                            batch["r_img"], batch["intrinsics"])
    variables = _numpy_params(shapes)
    state = torch_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), variables))
    torch.save({"model": cfg, "state": state, "lr": LR}, root / "cfg.pt")
    np.savez(root / "batch.npz", **batch)
    script = root / "step.py"
    script.write_text(_STEP)
    valid = [(batch["gt_disp"][b] > 0).sum() for b in range(B)]
    return dict(root=root, cfg=cfg, batch=batch, variables=variables,
                state=state, script=script, jm=jm, valid=valid)


def _jax_step(s, accum):
    """codd_tpu's ``make_train_step`` under SGD(LR) on the global batch."""
    tx = optax.sgd(LR)
    step = jtrainer.make_train_step(s["jm"], tx, jbuild_loss(s["cfg"]),
                                    accum_steps=accum)
    state, logs = step(jtrainer.create_train_state(s["variables"], tx),
                       {k: jnp.asarray(v) for k, v in s["batch"].items()})
    params = torch_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), state.params))
    return params, {k: float(v) for k, v in logs.items()}


def _port_step(s, accum, naive=False):
    out = s["root"] / f"out_{accum}_{int(naive)}.pt"
    _run_ranks(s["script"], [s["root"] / "cfg.pt", s["root"] / "batch.npz",
                             out, accum, int(naive)])
    return torch.load(out, weights_only=True)


def _param_error(got, want):
    """The largest difference over every parameter, relative to the
    largest updated parameter."""
    top = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / top


@pytest.mark.parametrize("accum", [1, 2])
def test_two_process_step_is_the_global_batch_step(stereo_step, accum):
    """Two processes, each with one clip, against codd_tpu's step on both
    (SGD at 1e-3: the update is the gradient, whose port-to-codd_tpu error
    is 1e-3 of its norm, tests/test_torch_train.py): the updated
    parameters within 1e-5 of the largest, the loss to 1e-5, grad_norm to
    1e-4.  The halves' valid pixels differ by more than 3x, so the counts
    must be the global batch's."""
    s = stereo_step
    assert s["valid"][0] > 3 * s["valid"][1]
    want, wlogs = _jax_step(s, accum)
    got = _port_step(s, accum)
    assert _param_error(got["params"], want) < 1e-5
    assert abs(got["logs"]["loss"] - wlogs["loss"]) <= 1e-5 * wlogs["loss"]
    assert abs(got["logs"]["grad_norm"] - wlogs["grad_norm"]) <= (
        1e-4 * wlogs["grad_norm"])
    if accum == 1:   # a per-process mean misses the bound by 10x or more
        naive = _port_step(s, accum, naive=True)
        assert _param_error(naive["params"], want) >= 1e-4


# ---------------------------------------------------------------------------
# evaluation: the rows' merge and the sharded run_inference
# ---------------------------------------------------------------------------

_MERGE = textwrap.dedent("""
    import sys, datetime
    from codd_torch.apis.evaluation import METER_NAMES, SUM_NAMES
    from codd_torch.apis.inference import _merge_hosts, summarize
    from codd_torch.parallel import mesh

    out_csv = sys.argv[1]
    mesh.init_distributed("cpu", timeout=datetime.timedelta(seconds=60))
    pid = mesh.process_index()

    class FakeDS:
        def __len__(self):
            return 5
        def sequence_name(self, i):
            return f"seq{i}"

    width = len(METER_NAMES) + len(SUM_NAMES)
    rows = [(i, [float(i * 10 + j) for j in range(width)])
            for i in range(pid, 5, 2)]
    merged = _merge_hosts(rows, FakeDS(), 2, out_csv if pid == 0 else None)
    assert sorted(merged.buffer) == [f"seq{i}" for i in range(5)], \\
        sorted(merged.buffer)
    if pid == 0:
        merged.dump()
    m = summarize(merged, log=lambda *a: None)
    assert abs(m[METER_NAMES[0]] - 20.0) < 1e-6, m  # mean of 0,10,..,40
    print("MERGED_OK")
    import torch
    torch.distributed.destroy_process_group()
""")


def test_two_process_eval_merge(tmp_path):
    """``_merge_hosts`` as tests/test_multihost.py drives codd_tpu's: every
    process ends with all 5 sequences in index order, and rank 0's CSV is
    complete."""
    script = tmp_path / "merge.py"
    script.write_text(_MERGE)
    csv = tmp_path / "merged.csv"
    outs = _run_ranks(script, [csv])
    assert all("MERGED_OK" in o for o in outs), outs
    lines = csv.read_text().strip().splitlines()
    assert len(lines) == 7  # header + 5 sequences + mean row
    assert lines[-1].startswith("mean")
    assert [l.split(",")[0] for l in lines[1:6]] == [f"seq{i}"
                                                     for i in range(5)]


def _write_dataset(root, seqs=("a", "b", "c"), frames=3):
    """A SceneFlow-layout dataset at 64x128: PNG pairs, PFM disparity and
    flow, a split file; and a stereo-only config on it."""
    import imageio.v2 as imageio
    rng = np.random.RandomState(0)
    lines = []
    for seq in seqs:
        for i in range(frames):
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
    cfg = root / "cfg.py"
    cfg.write_text(f"""
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
               num_frames=2, batch_size=1, disp_range=(1.0, 210.0),
               calib=1050, intrinsics=[100, 100, 64, 32],
               augment=dict(crop_size=({H}, {W}), photometric=True,
                            asym=True)),
    test=dict(preset="scene_flow", split=r"{split}", data_root=r"{root}",
              num_frames=-1, disp_range=(1.0, 210.0), calib=1050,
              intrinsics=[100, 100, 64, 32], pad_divisor=64),
)
data["val"] = data["test"]
schedule = dict(kind="constant", base_lr=1e-4, total_steps=2, grad_clip=1.0)
runtime = dict(log_interval=1, seed=0)
checkpoint = dict(interval=1)
""")
    return cfg


_EVAL = textwrap.dedent("""
    import sys, datetime, json
    import torch
    torch.set_num_threads(1)
    from codd_torch.apis.inference import run_inference
    from codd_torch.config import load_config
    from codd_torch.data.datasets import build_test_dataset
    from codd_torch.models.builder import build_estimator
    from codd_torch.parallel import mesh

    cfg_file, out_csv, out_json = sys.argv[1:4]
    grouped = mesh.launched_by_torchrun()
    if grouped:
        mesh.init_distributed("cpu", timeout=datetime.timedelta(seconds=120))
    cfg = load_config(cfg_file)
    model = build_estimator(cfg["model"], device="cpu", seed=0)
    ds = build_test_dataset(dict(cfg["data"]["test"]))
    metrics = run_inference(model, ds, evaluate=True, out_csv=out_csv,
                            log=lambda *a: None)
    with open(f"{out_json}.{mesh.process_index()}", "w") as f:
        json.dump(metrics, f)
    if grouped:
        torch.distributed.destroy_process_group()
""")


def test_sharded_run_inference_equals_one_process(tmp_path):
    """3 sequences over two processes (sequences 0 and 2 on rank 0, 1 on
    rank 1): every process returns the one-process summary, equal in
    bits, and rank 0's CSV is the one-process CSV."""
    cfg = _write_dataset(tmp_path)
    script = tmp_path / "eval.py"
    script.write_text(_EVAL)
    one = subprocess.run(
        [sys.executable, str(script), str(cfg), str(tmp_path / "one.csv"),
         str(tmp_path / "single")], env=_env(), capture_output=True,
        text=True, timeout=RUN_TIMEOUT)
    assert one.returncode == 0, one.stdout + one.stderr
    _run_ranks(script, [cfg, tmp_path / "two.csv", tmp_path / "two"])
    want = json.loads((tmp_path / "single.0").read_text())
    assert want and "count" in want
    for r in range(2):
        assert json.loads((tmp_path / f"two.{r}").read_text()) == want
    assert (tmp_path / "two.csv").read_text() == (
        tmp_path / "one.csv").read_text()
    assert len((tmp_path / "one.csv").read_text().splitlines()) == 5


# ---------------------------------------------------------------------------
# the training entry under torchrun
# ---------------------------------------------------------------------------

def _torchrun_train(cfg, work, *args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
           "--nproc_per_node=2", "--master_addr=127.0.0.1",
           f"--master_port={_free_port()}", "-m", "codd_torch.tools.train",
           str(cfg), "--device", "cpu", "--work-dir", str(work)]
    res = subprocess.run(cmd + list(args), env=_env(), capture_output=True,
                         text=True, timeout=RUN_TIMEOUT, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_torchrun_train_resumes_the_uninterrupted_run(tmp_path):
    """Two processes, each with a batch of 1 (rows ``rank::2`` of the
    shuffled clips): 2 steps with a checkpoint a step and validation at
    step 2 (its 3 sequences sharded over the ranks, the rows merged); then
    a resume from ``ckpt_1`` trains step 2 on the batches the
    uninterrupted run did and ends in its bits and its validation row.
    Rank 0 alone logs and writes; a checkpoint keeps both ranks' data
    streams, and one process cannot resume it."""
    from codd_torch.apis.train import train_estimator
    cfg = _write_dataset(tmp_path)
    val = ["--options", "evaluation.interval=2"]
    out = _torchrun_train(cfg, tmp_path / "full", "--max-steps", "2", *val)
    assert out.count("step 2/2") == 1, out
    rows = [json.loads(l) for l in
            (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]
    vrows = [r for r in rows if "val/epe" in r]
    assert [r["step"] for r in vrows] == [2] and vrows[0]["val/epe"] > 0
    blob = torch.load(tmp_path / "full" / "ckpt_2" / "state.pt",
                      weights_only=True)
    assert blob["step"] == 2 and blob["data"]["world"] == 2
    # both ranks' streams, alike here: every process seeds its pipeline
    # with runtime.seed as codd_tpu's hosts do, and draws as many numbers
    # a clip
    assert len(blob["data"]["ranks"]) == 2
    assert blob["data"]["ranks"][0] == blob["data"]["ranks"][1]
    _torchrun_train(cfg, tmp_path / "resumed", "--resume-from",
                    str(tmp_path / "full" / "ckpt_1"), "--max-steps", "2",
                    *val)
    again = torch.load(tmp_path / "resumed" / "ckpt_2" / "state.pt",
                       weights_only=True)
    assert again["step"] == 2
    for k, v in blob["params"].items():
        assert torch.equal(again["params"][k], v), k
    assert again["data"] == blob["data"]
    rrows = [json.loads(l) for l in (tmp_path / "resumed" / "metrics.jsonl")
             .read_text().splitlines()]
    rval = [r for r in rrows if "val/epe" in r]
    assert len(rval) == 1
    assert {k: v for k, v in rval[0].items() if k.startswith("val/")
            and k != "val/ms"} == {k: v for k, v in vrows[0].items()
                                   if k.startswith("val/") and k != "val/ms"}
    with pytest.raises(ValueError, match="processes"):
        train_estimator(load_config(str(cfg)), str(tmp_path / "one"),
                        resume_from=str(tmp_path / "full" / "ckpt_1"),
                        device="cpu", log=lambda *a: None)
