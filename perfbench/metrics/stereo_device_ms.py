"""Device time per streaming call of the operations launched inside the
stereo stage's forward (a record_function range opened by hooks on
``model.stereo``), in ms."""


def read(trace):
    if trace.kind != "stream" or not trace.calls or "stereo" not in trace.stage_s:
        return None
    return trace.stage_s["stereo"] * 1e3 / trace.calls
