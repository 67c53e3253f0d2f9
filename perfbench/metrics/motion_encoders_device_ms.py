"""Device time per streaming call of the operations launched inside the
program's ``codd.motion.features`` (the feature encoder and the
correlation pyramid) and ``codd.motion.context`` (the context encoder)
spans, in ms (``perfbench/harness/spans.py``)."""

from perfbench.harness import spans

PARTS = ("motion.features", "motion.context")


def read(trace):
    table = spans.of(trace)
    found = [table.device_s(p) for p in PARTS] if table is not None else []
    if not any(s is not None for s in found):
        return None
    return sum(s for s in found if s is not None) * 1e3 / trace.calls
