"""Pipeline builders (the test-time recipe; the training recipe is not
part of this package)."""

from __future__ import annotations

from typing import List

from .transforms import Normalize, Pad

__all__ = ["build_test_pipeline"]


def build_test_pipeline(pad_divisor: int = 64) -> List:
    return [Normalize(), Pad(size_divisor=pad_divisor)]
