"""Device time per streaming call of the operations launched inside the
motion stage's forward (a record_function range opened by hooks on
``model.motion``), in ms."""


def read(trace):
    if trace.kind != "stream" or not trace.calls or "motion" not in trace.stage_s:
        return None
    return trace.stage_s["motion"] * 1e3 / trace.calls
