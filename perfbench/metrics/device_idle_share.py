"""The share of a call's time in which no operation ran on the device,
in %: one less the traced device busy time per call (the union of the
device operations' intervals in the profiler's trace) over the mean
host-clock time of a ``step`` call in the untraced window (the profiler
slows the host, so the traced window's own length would read it)."""


def read(trace):
    if trace.kind != "stream" or not trace.calls or not trace.call_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.calls / trace.call_s)
