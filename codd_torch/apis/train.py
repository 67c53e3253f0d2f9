"""Training orchestration (counterpart of ``codd_tpu/apis/train.py``).

Flow: the model dict builds the model on the device and the loss config;
the data dict the dataset with the training pipeline; the schedule dict
the schedule, Adam and the clip.  Then ``batch_iterator`` ->
``Prefetcher`` (one thread) -> ``to_device`` -> ``make_train_step``'s
step, with logging at ``runtime.log_interval``, checkpoints at
``checkpoint.interval`` and the last step, and validation at
``evaluation.interval`` through ``run_inference`` on ``data.val``.

Where it differs from ``codd_tpu``:

* init: the model gets the port's seeded init (``build_estimator(seed=
  runtime.seed)``); ``codd_tpu`` inits from the first batch's shapes with
  ``PRNGKey(seed)``.  That first batch is drawn all the same and not
  trained on, so each step trains on the batch ``codd_tpu``'s would.
* one device, no mesh: ``codd_tpu``'s ``make_mesh`` / ``shard_batch``
  (``parallel/mesh.py``) is to become DDP (ROADMAP item 14).
* resume continues the data stream: a checkpoint keeps the pipeline's
  generator state after its step's batch, and ``batch_iterator`` passes
  over the batches drawn before it without loading them, so a resumed run
  trains on the batches the uninterrupted run would have (``codd_tpu``
  starts the stream again).
* the step's logs stay on the device until a log line reads them; a log
  line also has the host ms a step (data included) and the ms a step
  spent waiting on the prefetcher, over the steps since the last line.

``runtime.bf16_compute`` trains in bf16 on f32 masters, as ``codd_tpu``
does (``train/trainer.py``); validation runs the f32 model, and
checkpoints hold the f32 masters.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..data.datasets import build_test_dataset, make_dataset
from ..data.loader import Prefetcher, batch_iterator, to_device
from ..data.pipelines import (build_test_pipeline, build_train_pipeline,
                              pipeline_rng_state, set_pipeline_rng_state)
from ..models.builder import build_estimator, build_loss_config
from ..train.checkpoint import (restore_checkpoint, restore_params,
                                save_checkpoint)
from ..train.optim import (make_optimizer, multi_gamma_schedule,
                           one_cycle_schedule)
from ..train.trainer import TrainState, create_train_state, make_train_step
from ..utils.logging import MetricLogger
from .inference import run_inference

__all__ = ["build_schedule", "build_dataset_from_cfg", "train_estimator"]


def build_schedule(sched_cfg: Dict[str, Any], steps_per_epoch: int = 1
                   ) -> Callable[[int], float]:
    kind = sched_cfg.get("kind", "constant")
    lr = float(sched_cfg["base_lr"])
    if kind == "multi_gamma":
        milestones = sched_cfg["milestones"]
        if sched_cfg.get("by_epoch", False):
            milestones = [m * steps_per_epoch for m in milestones]
        return multi_gamma_schedule(lr, milestones, sched_cfg["gammas"])
    if kind == "one_cycle":
        return one_cycle_schedule(lr, int(sched_cfg["total_steps"]))
    return lambda step: lr


def build_dataset_from_cfg(dcfg: Dict[str, Any], train: bool, seed: int = 0):
    dcfg = dict(dcfg)
    preset = dcfg.pop("preset")
    aug = dcfg.pop("augment", None)
    dcfg.pop("batch_size", None)
    pad_divisor = dcfg.pop("pad_divisor", 64)
    if train:
        pipeline = build_train_pipeline(aug, seed=seed)
    else:
        pipeline = build_test_pipeline(pad_divisor)
    return make_dataset(preset, pipeline=pipeline, **dcfg)


def _with_rng_state(it, pipeline):
    """Each batch with the pipeline's generator state right after it was
    drawn (runs in the prefetch thread)."""
    for batch in it:
        yield batch, pipeline_rng_state(pipeline)


def train_estimator(
    cfg,
    work_dir: str,
    load_from: Optional[str] = None,
    resume_from: Optional[str] = None,
    max_steps: Optional[int] = None,
    log=print,
    device="cuda",
) -> Tuple[TrainState, int]:
    """Train as ``cfg`` says on ``device``; returns the state and the step
    it reached.  The log lines' rows and the ``val/*`` rows go to
    ``work_dir/metrics.jsonl``."""
    os.makedirs(work_dir, exist_ok=True)
    runtime = cfg.get("runtime", {})
    seed = int(runtime.get("seed", 0))

    model = build_estimator(cfg["model"], device=device, seed=seed)
    train_dcfg = cfg["data"]["train"]
    loss_cfg = build_loss_config(cfg["model"], disp_range=tuple(
        train_dcfg.get("disp_range", (1.0, 210.0))))

    sched_cfg = cfg["schedule"]
    dataset = build_dataset_from_cfg(train_dcfg, train=True, seed=seed)
    batch_size = int(train_dcfg.get("batch_size", 4))
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    total_steps = int(sched_cfg.get("total_steps")
                      or sched_cfg.get("total_epochs", 1) * steps_per_epoch)
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)
    schedule = build_schedule(sched_cfg, steps_per_epoch)

    train_cfg = cfg["model"].get("train_cfg") or {}
    frozen = [name for flag, name in (("freeze_stereo", "stereo"),
                                      ("freeze_motion", "motion"),
                                      ("freeze_fusion", "fusion"))
              if train_cfg.get(flag)]
    opt = make_optimizer(schedule, float(sched_cfg.get("grad_clip", 1.0)),
                         params=dict(model.named_parameters()),
                         frozen_prefixes=frozen)
    # microbatch gradient accumulation (schedule.accum_steps); bf16
    # compute on the f32 masters (runtime.bf16_compute)
    accum = int(sched_cfg.get("accum_steps", 1))
    bf16 = bool(runtime.get("bf16_compute", False))
    step_fn = make_train_step(model, opt, loss_cfg, accum_steps=accum,
                              bf16_compute=bf16)
    if bf16:
        log("bf16 compute enabled (f32 master params)")
    state = create_train_state(model, opt)

    data_state = None
    if resume_from:
        state, data_state = restore_checkpoint(resume_from, model, state)
        log(f"resumed from {resume_from} at step {state.opt_state.count}")
    elif load_from:
        restore_params(load_from, model)
        log(f"loaded weights from {load_from}")
    start = state.opt_state.count
    if data_state is not None:
        set_pipeline_rng_state(dataset.pipeline, data_state)

    log_interval = int(runtime.get("log_interval", 50))
    ckpt_interval = int(cfg.get("checkpoint", {}).get("interval", 5000))
    mlog = MetricLogger(work_dir)

    # validation during training; a missing val dataset only logs
    eval_interval = int(cfg.get("evaluation", {}).get("interval", 0) or 0)
    val_cfg = cfg.get("data", {}).get("val")
    val = {"dataset": None}

    def run_validation(step):
        if not eval_interval or not val_cfg:
            return
        t0 = time.perf_counter()
        try:
            if val["dataset"] is None:
                val["dataset"] = build_test_dataset(dict(val_cfg))
            with torch.no_grad():
                metrics = run_inference(model, val["dataset"], evaluate=True,
                                        log=log)
        except OSError as e:
            log(f"validation skipped: {e}")
            return
        row = {f"val/{k}": v for k, v in metrics.items()}
        row["val/ms"] = 1e3 * (time.perf_counter() - t0)
        mlog.log(step, row)

    # the stream starts after the batches drawn up to ``start``: the init
    # batch (as codd_tpu's) and one a step
    it = batch_iterator(dataset, batch_size, seed=seed,
                        skip=start + 1 if start else 0)
    batches = Prefetcher(_with_rng_state(it, dataset.pipeline))
    step = start
    try:
        if not start:
            next(batches)  # codd_tpu's init batch, not trained on
        t_mark, n_mark, wait = time.perf_counter(), step, 0.0
        while step < total_steps:
            t0 = time.perf_counter()
            try:
                batch, rng_state = next(batches)
            except StopIteration:
                break
            wait += time.perf_counter() - t0
            state, logs = step_fn(state, to_device(batch, device))
            step += 1
            marked = False
            if step % log_interval == 0 or step == total_steps:
                row = {k: float(v) for k, v in logs.items()}  # the sync
                n = step - n_mark
                secs = time.perf_counter() - t_mark
                row.update(lr=float(schedule(step)),
                           it_per_s=n / max(secs, 1e-9),
                           step_ms=1e3 * secs / n,
                           data_wait_ms=1e3 * wait / n)
                log(f"step {step}/{total_steps} loss={row['loss']:.4f} "
                    f"lr={row['lr']:.2e} it/s={row['it_per_s']:.2f} "
                    f"grad_norm={row['grad_norm']:.3f} "
                    f"data_wait={row['data_wait_ms']:.1f}ms")
                mlog.log(step, row)
                marked = True
            if step % ckpt_interval == 0 or step == total_steps:
                path = save_checkpoint(
                    os.path.join(work_dir, f"ckpt_{step}"), model, state,
                    data_state=rng_state,
                    meta={"step": step, "config": dict(cfg)})
                log(f"saved {path}")
                marked = True
            if eval_interval and step % eval_interval == 0:
                run_validation(step)
                marked = True
            if marked:  # the next line times steps only
                t_mark, n_mark, wait = time.perf_counter(), step, 0.0
    finally:
        batches.close()
        mlog.close()
    return state, step
