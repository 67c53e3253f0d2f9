"""The lower-precision control: the reference with every convolution and
matrix product computed in TF32, the precision one step below the
configuration's float32 with TF32 off.  On the card that is cuDNN's and
cuBLAS's own TF32 mode, forward and backward (``lower_precision``).  The
CPU has no such mode: there ``TF32Products`` rounds each forward
product's float32 operands to TF32 (10 mantissa bits, round to nearest
even, the gradient passed straight through) and sums their products in
float32, as the tensor cores do."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["to_tf32", "TF32Products", "lower_precision"]

_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.mm,
             torch.bmm, torch.einsum, torch.Tensor.__matmul__,
             torch.Tensor.matmul, torch.Tensor.bmm, torch.Tensor.mm,
             torch.baddbmm, torch.addmm}


def to_tf32(x):
    """float32 -> the nearest TF32 value (as float32); others unchanged."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    r = i.view(torch.float32).view(x.shape)
    return x + (r - x).detach() if x.requires_grad else r


class TF32Products(TorchFunctionMode):
    """Within the block, the products listed above take TF32 operands."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                args = (args[0],) + tuple(to_tf32(a) for a in args[1:])
            else:
                args = tuple(to_tf32(a) for a in args)
                kwargs = {k: to_tf32(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def lower_precision(device):
    """TF32 products within the block: the card's TF32 mode on CUDA,
    ``TF32Products`` on the CPU."""
    if torch.device(device).type != "cuda":
        with TF32Products():
            yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
