"""The hand kernels' share of their roofline: the sum of their bounds
(perfbench/harness/work.py, counted on the reference at the cell's
shapes, per call) over their device time in the trace, in %.  Nothing
when the program launched other hand kernels than the reference counted
(then the bounds would not be the traced work's)."""


def read(trace):
    if trace.kind != "stream" or not trace.calls or trace.hand_s <= 0:
        return None
    want = {k: v * trace.calls for k, v in trace.work.get("launches", {}).items()}
    if want != trace.counts:
        return None
    bound = sum(trace.work["bound_s"].values()) * trace.calls
    return 100.0 * bound / trace.hand_s
