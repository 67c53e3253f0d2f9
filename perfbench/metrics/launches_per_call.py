"""Device operations (kernels, copies, fills) per streaming call, counted
in the profiler's (CUPTI) trace of the traced calls."""


def read(trace):
    if trace.kind != "stream" or not trace.calls:
        return None
    return trace.launches / trace.calls
