"""Seeded weights for CODD, made on the device in one draw: lecun-normal
convolution kernels, zero biases, frozen norms at identity statistics
(the scheme of the port's ``build_estimator(seed=...)``, drawn here by
the benchmark's own generator).  The names and shapes come from the
reference model, so the port and the reference load the same tensors."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .scenes import generator

__all__ = ["make_state"]


def make_state(reference: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A full state dict for ``reference``'s architecture from ``seed``."""
    fan_in = {}
    for mod in reference.modules():
        w = getattr(mod, "weight", None)
        if isinstance(w, nn.Parameter) and w.ndim == 4:
            # (O, I, kh, kw) kernels and (I, O, kh, kw) transposed ones
            lead = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
            fan_in[id(w)] = lead * w.shape[2] * w.shape[3]
    params = dict(reference.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in reference.state_dict().items()}
    kernels = [k for k in shapes if k in params and id(params[k]) in fan_in]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in kernels),
                       generator=generator(device, seed, "weights"),
                       device=device)
    state, at = {}, 0
    for k in kernels:
        n = math.prod(shapes[k])
        state[k] = flat[at:at + n].view(shapes[k]) / math.sqrt(fan_in[id(params[k])])
        at += n
    for k, shape in shapes.items():
        if k in state:
            continue
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean"):
            state[k] = torch.zeros(shape, device=device)
        elif leaf in ("weight", "running_var") and len(shape) == 1:
            state[k] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"make_state: no rule for {k} {shape}")
    return state
