"""Weight bridge: ``codd_tpu`` flax variables -> ``codd_torch`` state_dict.

The torch submodules carry the flax module names, so a flax leaf path
``a/b/c/leaf`` becomes the state_dict key ``a.b.c.<name>`` by one rule per
leaf kind:

* conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw);
* ConvTranspose ``kernel`` (kh, kw, I, O) -> ``weight`` (I, O, kh, kw),
  spatially flipped (flax applies the kernel unflipped, torch's transposed
  convolution flipped); the only ConvTranspose layers are HITUNet's
  ``up1`` .. ``up4``, and no other layer is named ``up<digit>``;
* dense ``kernel`` (I, O) -> ``weight`` (O, I);
* ``bias`` -> ``bias``;
* FrozenBatchNorm ``scale`` / ``bias`` params -> ``weight`` / ``bias``,
  ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  buffers.

Input: a nested dict of numpy arrays, either the whole variables dict
(``{"params": ..., "batch_stats": ...}``) or the ``params`` tree alone.
The tree of a stereo-only or a stereo + motion ``codd_tpu`` model simply
lacks the ``motion`` / ``fusion`` subtrees; the result loads strictly
(``load_state_dict(strict=True)``) into the port's model built from the
same config, and into no other.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["torch_state_dict_from_jax"]

_CONV_TRANSPOSE = re.compile(r"(^|/)up\d/conv/kernel$")
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _convert(path: str, value) -> Tuple[str, np.ndarray]:
    a = np.asarray(value, dtype=np.float32)
    parts = path.split("/")
    leaf = parts[-1]
    if leaf == "kernel":
        if a.ndim == 4 and _CONV_TRANSPOSE.search(path):
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        name = "weight"
    else:
        name = _RENAME.get(leaf, leaf)
    return ".".join(parts[:-1] + [name]), np.array(a, copy=True, order="C")


def torch_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of numpy arrays) -> torch state_dict."""
    cols = (variables if "params" in variables
            else {"params": variables})
    out = {}
    for col in ("params", "batch_stats"):
        for path, v in _leaves(cols.get(col, {})):
            key, a = _convert(path, v)
            out[key] = torch.from_numpy(a)
    return out
