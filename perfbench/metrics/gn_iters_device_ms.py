"""Device time per streaming call of the operations launched inside the
program's ``codd.motion.gn_iter`` spans (the GN iterations: lookup,
ConvGRU update, GN step), in ms (``perfbench/harness/spans.py``)."""

from perfbench.harness import spans


def read(trace):
    table = spans.of(trace)
    if table is None or table.device_s("motion.gn_iter") is None:
        return None
    return table.device_s("motion.gn_iter") * 1e3 / trace.calls
