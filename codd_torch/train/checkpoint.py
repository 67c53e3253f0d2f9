"""Training checkpoints in torch's own format (counterpart of
``codd_tpu/train/checkpoint.py``, which writes orbax trees).

A checkpoint is a directory ``ckpt_<step>`` with ``state.pt``, one
``torch.save`` of

    {"step": int,
     "params": the model's state_dict (parameters and the frozen
               batch-norm statistics), on the CPU,
     "opt_state": {"count": int, "mu": {name: tensor}, "nu": {...}},
     "data": {"world": the number of processes,
              "ranks": each process's training pipeline's generator state
                       after the step's batch, by rank
                       (``data.pipelines.pipeline_rng_state``)}, or None}

and ``meta.json`` (the step and the config).  Adam's moments exist for the
trained parameters only (``train/optim.py``).  Two flows, as in
``codd_tpu``:

  * ``--resume-from``: ``restore_checkpoint``, params + optimizer + step
    (and the data stream's position, which ``codd_tpu`` does not keep:
    ``rank_data_state`` takes a process's own, and raises when the number
    of processes differs from the checkpoint's);
  * ``--load-from``: ``restore_params``, weights only; the optimizer state
    on disk is ignored.  Given a file, not a ``ckpt_<step>`` directory,
    it loads a plain ``state_dict`` (inference weights) through
    ``utils/checkpoint.py:load_checkpoint``.

Files load with ``weights_only=True``.  A missing or an extra key raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.checkpoint import load_checkpoint
from .optim import AdamState
from .trainer import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_params",
           "rank_data_state", "STATE_FILE"]

STATE_FILE = "state.pt"


def save_checkpoint(path: str, model: torch.nn.Module, state: TrainState,
                    data_state: Optional[Dict[str, Any]] = None,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (with the model's buffers) under the directory
    ``path``; returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)

    def cpu(tree):
        return {k: v.detach().cpu() for k, v in tree.items()}

    opt = state.opt_state
    blob = {"step": int(opt.count), "params": cpu(model.state_dict()),
            "opt_state": {"count": int(opt.count), "mu": cpu(opt.mu),
                          "nu": cpu(opt.nu)},
            "data": data_state}
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if meta:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    return path


def _load(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def _same_keys(what: str, got, want) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint {what}: missing {missing[:5]} "
                       f"({len(missing)}), unexpected {extra[:5]} "
                       f"({len(extra)})")


def restore_params(path: str, model: torch.nn.Module) -> None:
    """Weights only, into ``model`` in place (``--load-from``): a training
    checkpoint's ``ckpt_<step>`` directory, or a plain ``state_dict``
    file through ``load_checkpoint``."""
    if not os.path.isdir(path):
        load_checkpoint(model, path)
        return
    blob = _load(path)
    _same_keys("params", blob["params"], model.state_dict())
    model.load_state_dict(blob["params"], strict=True)


def restore_checkpoint(path: str, model: torch.nn.Module, state: TrainState
                       ) -> Tuple[TrainState, Optional[Dict[str, Any]]]:
    """Full resume (``--resume-from``): the params into ``model`` in place,
    Adam's count and moments on the parameters' devices; returns the new
    state and the data stream's state."""
    blob = _load(path)
    _same_keys("params", blob["params"], model.state_dict())
    opt = blob["opt_state"]
    for k in ("mu", "nu"):
        _same_keys(f"opt_state.{k}", opt[k], state.opt_state.mu)
    if opt["count"] != blob["step"]:
        raise ValueError(f"checkpoint {path}: step {blob['step']} but Adam's "
                         f"count {opt['count']}")
    model.load_state_dict(blob["params"], strict=True)
    dev = {k: state.params[k].device for k in state.opt_state.mu}

    def moved(tree):
        return {k: v.to(dev[k]) for k, v in tree.items()}

    return (TrainState(params=state.params,
                       opt_state=AdamState(count=int(opt["count"]),
                                           mu=moved(opt["mu"]),
                                           nu=moved(opt["nu"]))),
            blob.get("data"))


def rank_data_state(data: Optional[Dict[str, Any]], rank: int, world: int
                    ) -> Optional[Dict[str, Any]]:
    """Process ``rank``'s data stream state from a checkpoint's ``data``
    (None where it has none); raises where the checkpoint was written by
    another number of processes, whose streams cannot be resumed exactly.
    A ``data`` without ``"ranks"`` is one process's state."""
    if data is None:
        return None
    if "ranks" not in data:
        data = {"world": 1, "ranks": [data]}
    if data["world"] != world or len(data["ranks"]) != world:
        raise ValueError(f"checkpoint written by {data['world']} processes "
                         f"cannot resume {world}: each process's data stream "
                         "is kept, and they would not continue")
    return data["ranks"][rank]
