"""Checkpoints of the port: a ``torch.save``d ``state_dict``, loaded
strictly (every key must match the model built from the config)."""

from __future__ import annotations

import os

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(model: torch.nn.Module, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return path


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load ``path`` into ``model`` in place; a missing or unexpected key
    raises.  ``weights_only`` keeps the unpickler to tensors."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
