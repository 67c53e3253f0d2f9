"""Optimizer and learning-rate schedules of the three-stage CODD recipe
(counterpart of ``codd_tpu/train/optim.py``, which chains optax's
``clip_by_global_norm`` and ``adam`` and masks frozen modules with
``set_to_zero``):

* stereo: Adam 4e-4, MultiGamma decay, global-norm clip 1.0
  (``configs/schedules/schedule_stereo.py``);
* motion and fusion: OneCycle, max lr 2e-4 (``schedule_motion.py``,
  ``schedule_fusion.py``).

The optimizer is functional, as optax's: ``init(params)`` makes the state,
``update(grads, state)`` returns the updates and the new state, and
``apply_updates`` adds them to the parameters (in place).  Parameters,
gradients and updates are dicts name -> tensor (``named_parameters()``).
The arithmetic is optax's step for step: the clip scales by ``max_norm /
norm`` only where ``norm >= max_norm``, as ``(g / norm) * max_norm``
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm), and Adam
keeps eps outside the square root and corrects its moments' bias from
step 1.  A frozen parameter gets no update and has no optimizer state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["multi_gamma_schedule", "one_cycle_schedule", "freeze_mask",
           "make_optimizer", "Optimizer", "AdamState", "apply_updates"]

# optax.adam's defaults, which codd_tpu's make_optimizer keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


def multi_gamma_schedule(base_lr: float, milestones: Sequence[int],
                         gammas: Sequence[float]) -> Callable[[int], float]:
    """Multiplicative decay by ``gammas[i]`` from optimizer step
    ``milestones[i]`` on, in f32 as ``codd_tpu`` computes it."""
    milestones, gammas = list(milestones), list(gammas)

    def schedule(step: int) -> float:
        lr = np.float32(base_lr)
        for m, g in zip(milestones, gammas):
            if step >= m:
                lr = lr * np.float32(g)
        return float(lr)

    return schedule


def one_cycle_schedule(max_lr: float, total_steps: int,
                       pct_start: float = 0.3, div_factor: float = 25.0,
                       final_div_factor: float = 1e4
                       ) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``: cosine from ``max_lr /
    div_factor`` up to ``max_lr`` over the first ``int(pct_start *
    total_steps)`` steps, then down to ``max_lr / (div_factor *
    final_div_factor)`` at ``total_steps``, constant after.  (PyTorch's
    ``OneCycleLR`` puts its phase boundaries elsewhere.)"""
    if total_steps <= 0:
        raise ValueError("one_cycle_schedule: total_steps must be positive")
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    init = max_lr / div_factor
    values = [init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor)]

    def schedule(step: int) -> float:
        for k in range(2):
            if bounds[k] <= step < bounds[k + 1]:
                pct = (step - bounds[k]) / (bounds[k + 1] - bounds[k])
                start, end = values[k], values[k + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return values[-1] if step >= bounds[-1] else 0.0

    return schedule


def freeze_mask(params: Dict[str, torch.Tensor],
                frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """True (trainable) / False (frozen) by top-level module name."""
    frozen = set(frozen_prefixes)
    return {k: k.split(".")[0] not in frozen for k in params}


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Optimizer:
    """Global-norm clip, then Adam with a schedule, over the parameters
    that ``trainable`` marks (all of them when it is None)."""

    def __init__(self, schedule: Callable[[int], float],
                 grad_clip: float = 1.0,
                 trainable: Optional[Dict[str, bool]] = None):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.trainable = trainable

    def trained_names(self, tree):
        """The keys of ``tree`` that this optimizer updates."""
        return [k for k in tree
                if self.trainable is None or self.trainable.get(k, True)]

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        names = self.trained_names(params)
        zeros = lambda: {k: torch.zeros_like(params[k],  # noqa: E731
                                             memory_format=torch.preserve_format)
                         for k in names}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params=None) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        names = self.trained_names(grads)
        g = {k: grads[k] for k in names}
        norm = torch.sqrt(sum((torch.sum(v * v) for v in g.values()),
                              torch.zeros(())))
        clip = norm < self.grad_clip
        g = {k: torch.where(clip, v, (v / norm) * self.grad_clip)
             for k, v in g.items()}
        b1, b2 = B1, B2
        mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in names}
        nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * state.nu[k] for k in names}
        count = state.count + 1
        c1 = np.float32(1) - np.float32(b1) ** count
        c2 = np.float32(1) - np.float32(b2) ** count
        lr = np.float32(-self.schedule(state.count))
        updates = {k: (mu[k] / float(c1))
                   / (torch.sqrt(nu[k] / float(c2)) + EPS) * float(lr)
                   for k in names}
        return updates, AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """params += updates, in place (parameters without an update keep
    their bits)."""
    for k, u in updates.items():
        params[k].add_(u)


def make_optimizer(schedule: Callable[[int], float], grad_clip: float = 1.0,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   frozen_prefixes: Sequence[str] = ()) -> Optimizer:
    """Adam with a global-norm clip; with ``params`` and
    ``frozen_prefixes``, the parameters under those top-level modules
    frozen."""
    trainable = None
    if frozen_prefixes and params is not None:
        trainable = freeze_mask(params, frozen_prefixes)
    return Optimizer(schedule, grad_clip, trainable)
