"""Device time per streaming call of the operations launched inside the
fusion stage's forward (a record_function range opened by hooks on
``model.fusion``), in ms."""


def read(trace):
    if trace.kind != "stream" or not trace.calls or "fusion" not in trace.stage_s:
        return None
    return trace.stage_s["fusion"] * 1e3 / trace.calls
