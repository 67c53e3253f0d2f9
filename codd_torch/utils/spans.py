"""Named ranges at the model's layer boundaries, for ``torch.profiler``.

    with span("motion"):          # "codd.motion" in the profiler's trace
        ...

While a torch profiler records, ``span(name)`` is a
``torch.profiler.record_function`` range named ``"codd." + name``: it
lands in the same (Kineto) trace as the device operations, on one clock,
so each operation can be attributed to the innermost span around the
host call that launched it.  Otherwise it is one shared null context: a
check of the profiler's flag (~0.3 us), where an unguarded
``record_function`` costs ~7 us even with no profiler on.  There is no
switch: spans exist exactly while a profiler records.

The spans (README.md, "on the card"): ``first_step`` / ``step`` (a call's
root), ``stereo`` (``.backbone``, ``.init``, ``.propagate``), ``motion``
(``.encode`` at frame 0; ``.features``, one ``.gn_iter`` an iteration,
``.upsample``, ``.context``, ``.splat``), ``gn.lookup`` / ``gn.update`` /
``gn.solve`` inside each iteration, ``project`` and ``fusion``.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["PREFIX", "span"]

PREFIX = "codd."
_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``PREFIX + name`` while a profiler records,
    else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL
