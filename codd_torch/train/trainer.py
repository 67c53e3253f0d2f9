"""The training step (counterpart of ``codd_tpu/train/trainer.py``):
loss -> gradients -> the clipped Adam update, with microbatch
accumulation and per-element non-finite zeroing.

    opt = make_optimizer(schedule, 1.0, dict(model.named_parameters()),
                         frozen_prefixes=["motion"])
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, build_loss_config(model_cfg))
    state, logs = step(state, batch)

A batch holds ``l_img`` / ``r_img`` (B,T,H,W,3), ``gt_disp``
(B,T,H,W,1), ``intrinsics`` (B,4), and optionally ``gt_flow``,
``gt_disp_change``, ``gt_flow_occ``, ``gt_disp2``, ``gt_semantic_seg``.
The parameters are the model's own and are updated in place; the state
carries the optimizer's step count and moments.

Several processes (``torchrun``; ``parallel/mesh.py``) each hold their
rows of the global batch, as ``codd_tpu``'s data-sharded ``jit`` does.
The step then computes what ``codd_tpu``'s computes on the global batch:
each loss term is divided by its count summed over the processes
(``parallel.mesh.counting``: the loss is taken once to record the counts
and once more with their sums), so the processes' losses add up to the
global loss; the gradients are summed over the processes before the
norm, the non-finite zeroing and the clip; microbatch i is rows
[i B/A, (i+1) B/A) of the global batch, of which a process holds a part,
perhaps none; and the logs are the global ones.

``bf16_compute=True`` is ``codd_tpu``'s mixed precision: the parameters
stay f32 masters; the loss runs the model on bf16 copies of them and of
its buffers and on bf16 frames (the intrinsics stay f32), compute follows
the dtypes, and every bf16 output is cast to f32 before
``codd_train_loss``.  Autograd through the casts gives f32 gradients, and
Adam updates the f32 masters.  The copies stand in the modules for the
forward and the backward both, so that what ``torch.utils.checkpoint``
recomputes in the backward (RAFT-3D's GN iterations) runs on them too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..losses.assembly import LossConfig, codd_train_loss
from ..parallel import mesh
from ..utils.precision import cast_floats
from .optim import AdamState, Optimizer, apply_updates

__all__ = ["TrainState", "compute_copies", "create_train_state",
           "make_train_step", "training_forward"]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamState


def create_train_state(model: torch.nn.Module,
                       optimizer: Optimizer) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=optimizer.init(params))


@contextlib.contextmanager
def compute_copies(model: torch.nn.Module, dtype: torch.dtype):
    """Within the block every floating parameter and buffer of ``model`` is
    a ``dtype`` copy of itself, cast in the autograd graph: the gradient
    reaches the leaf through the cast.  The leaves are put back after."""
    swapped = []
    for mod in model.modules():
        for table in (mod._parameters, mod._buffers):
            for name, t in list(table.items()):
                if t is not None and t.is_floating_point():
                    swapped.append((table, name, t))
                    table[name] = t.to(dtype)
    try:
        yield
    finally:
        for table, name, t in reversed(swapped):
            table[name] = t


@contextlib.contextmanager
def training_forward(model: torch.nn.Module, bf16_compute: bool = False):
    """The step's forward of one microbatch in the step's precision: yields
    ``forward(batch) -> (outputs, raw)``, ``raw`` the model's own training
    outputs and ``outputs`` what ``codd_train_loss`` takes.  With
    ``bf16_compute`` (the module's docstring) the model runs on bf16
    copies of its parameters and buffers and on bf16 frames, the
    intrinsics stay f32, and ``outputs`` are ``raw`` cast to f32.  The
    block holds the backward too: checkpointed stages recompute there, on
    the copies."""

    def forward(batch):
        gt_seq = {k: v for k, v in batch.items() if k.startswith("gt_")}
        frames = (batch["l_img"], batch["r_img"])
        if bf16_compute:
            frames = cast_floats(frames)
        raw = model(*frames, batch["intrinsics"], train=True,
                    gt_seq=gt_seq or None)
        return (cast_floats(raw, torch.float32) if bf16_compute else raw,
                raw)

    with (compute_copies(model, torch.bfloat16) if bf16_compute
          else contextlib.nullcontext()):
        yield forward


def _local_rows(i: int, b: int, rank: int, local: int) -> slice:
    """This process's rows of global microbatch i (rows [i b, (i+1) b) of
    the global batch, whose rows [rank local, (rank+1) local) it holds),
    as a slice of its own batch; empty where it holds none."""
    lo, hi = max(i * b, rank * local), min((i + 1) * b, (rank + 1) * local)
    return slice(lo - rank * local, max(hi, lo) - rank * local)


def _global_counts(counts, device):
    """The counts a loss took on this process's rows (None: it holds no
    rows of the microbatch), summed over the processes; two all-reduces,
    which every process makes whether or not it holds rows."""
    n = torch.tensor([0.0 if counts is None else float(len(counts))],
                     dtype=torch.float64, device=device)
    torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MAX)
    vec = (torch.stack(counts).to(device) if counts
           else torch.zeros(int(n), dtype=torch.float64, device=device))
    if vec.numel() != int(n):
        raise RuntimeError(f"the processes' losses took {vec.numel()} and "
                           f"{int(n)} counts")
    return mesh.all_reduce_sum(vec)


def make_train_step(model, optimizer: Optimizer, loss_cfg: LossConfig,
                    accum_steps: int = 1, bf16_compute: bool = False
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step function.  ``accum_steps > 1`` splits the batch axis into
    that many microbatches and averages their gradients before the one
    update (the losses are batch means); B must divide by it.  The logs
    gain ``grad_norm`` (the global norm of the gradients before the
    non-finite zeroing) and ``step_skipped`` (1 where the loss or that
    norm is not finite; the non-finite elements of the gradients are
    zeroed, so the step is a no-op for them).  ``bf16_compute`` runs the
    loss in bf16 on the f32 masters (the module's docstring).  Under a
    process group the batch is this process's rows of the global batch
    and the step is the global batch's (the module's docstring)."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        for p in params.values():
            p.grad = None
        world, rank = mesh.process_count(), mesh.process_index()
        grouped = world > 1
        local = batch["l_img"].shape[0]
        B = local * world
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accum_steps "
                             f"{accum_steps}")
        b = B // accum_steps
        loss, logs = 0.0, {}
        for i in range(accum_steps):
            rows = _local_rows(i, b, rank, local)
            mb = {k: v[rows] for k, v in batch.items()}
            if rows.stop <= rows.start:   # none of this microbatch here
                _global_counts(None, batch["l_img"].device)
                continue
            with training_forward(model, bf16_compute) as forward:
                outs = forward(mb)[0]
                given = None
                if grouped:   # record the counts, then take their sums
                    with mesh.counting() as rec:
                        codd_train_loss(loss_cfg, outs, mb)
                    given = _global_counts(rec.seen, batch["l_img"].device)
                with mesh.counting(given) if grouped \
                        else contextlib.nullcontext():
                    l, lg = codd_train_loss(loss_cfg, outs, mb)
                if l.requires_grad:
                    l.backward()
            loss = loss + l.detach()
            for k, v in lg.items():
                logs[k] = logs.get(k, 0.0) + v.detach()
        if mesh.process_group_active():
            grads = mesh.all_reduce_grads(params)
        else:
            # a parameter without .grad (frozen, or out of the loss's
            # reach) has a zero gradient: it adds nothing to the norm
            grads = {k: p.grad for k, p in params.items()
                     if p.grad is not None}
        if grouped:   # the global loss and logs: sums of the processes'
            keys = sorted(logs)
            flat = mesh.all_reduce_sum(torch.stack(
                [torch.as_tensor(loss, device=batch["l_img"].device)]
                + [logs[k] for k in keys]).float())
            loss = flat[0]
            logs = {k: flat[j + 1] for j, k in enumerate(keys)}
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            loss = loss * inv
            logs = {k: v * inv for k, v in logs.items()}
            grads = {k: g * inv for k, g in grads.items()}
        with torch.no_grad():
            gnorm = torch.sqrt(sum((torch.sum(g * g) for g in grads.values()),
                                   loss.new_zeros(())))
            grads = {k: torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                     for k, g in grads.items()}
            # Adam still moves a trained parameter whose gradient is zero
            for k in optimizer.trained_names(params):
                if k not in grads:
                    grads[k] = torch.zeros_like(params[k])
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  params)
            apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        logs["grad_norm"] = gnorm
        logs["step_skipped"] = (~(torch.isfinite(loss) & torch.isfinite(gnorm))
                                ).float()
        return TrainState(params=params, opt_state=opt_state), logs

    return step_fn
