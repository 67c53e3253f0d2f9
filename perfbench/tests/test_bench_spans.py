"""The reduction of the program's ``codd.`` spans
(``perfbench/harness/spans.py``) and the three readers built on it, on a
synthetic Chrome trace of two ``step`` calls: runtime launches, device
operations, the harness's ``perfbench.`` stage ranges and the program's
``codd.`` spans, every number placed by hand."""

import pytest

from perfbench.harness import spans
from perfbench.harness.common import metric_readers
from perfbench.harness.trace import Trace

CALLS = 2
# per call, offset 1000 us a call: (name, start us, end us)
CODD = [("step", 0, 100), ("stereo", 1, 20), ("motion", 21, 80),
        ("motion.features", 23, 30),
        ("motion.gn_iter", 31, 50), ("gn.lookup", 32, 35), ("gn.update", 36, 45),
        ("gn.solve", 46, 49),
        ("motion.gn_iter", 51, 70), ("gn.lookup", 52, 55), ("gn.update", 56, 65),
        ("gn.solve", 66, 69),
        ("motion.context", 71, 78), ("fusion", 81, 95)]
HOOKS = [("stereo", 2, 19), ("motion", 22, 79), ("fusion", 82, 94)]
# (launch us, device start us, device us, innermost span); the last is
# the output's copy, launched after the call
OPS = [(10, 110, 20, "stereo"), (25, 130, 10, "motion.features"),
       (33, 140, 5, "gn.lookup"), (40, 150, 10, "gn.update"),
       (47, 160, 2, "gn.solve"), (50, 162, 1, "motion.gn_iter"),
       (60, 170, 8, "gn.update"), (75, 178, 12, "motion.context"),
       (22.5, 190, 3, "motion"), (90, 195, 5, "fusion"), (150, 205, 3, None)]


def events(with_codd=True):
    ev, corr = [], 0
    for k in range(CALLS):
        o = 1000.0 * k
        for name, t0, t1 in CODD if with_codd else []:
            ev.append({"ph": "X", "cat": "user_annotation", "name": "codd." + name,
                       "ts": o + t0, "dur": t1 - t0})
        for name, t0, t1 in HOOKS:
            ev.append({"ph": "X", "cat": "user_annotation", "name": "perfbench." + name,
                       "ts": o + t0, "dur": t1 - t0})
        for lts, t0, d, _ in OPS:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": o + lts, "dur": 0.5, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "gpu_memcpy" if lts == 150 else "kernel",
                       "name": f"op{corr % len(OPS)}", "ts": o + t0, "dur": d,
                       "args": {"correlation": corr}})
    return ev


def trace(with_codd=True):
    ev = events(with_codd)
    tr = Trace(ev, CALLS, 0.002, "stream", [])
    tr.spans = spans.collect(ev)
    return tr


def read(quantity, tr):
    (_, reader), = metric_readers([{"name": quantity}]).values()
    return reader(tr)


def test_each_operation_lands_in_its_innermost_span():
    tr = trace()
    table = spans.of(tr)
    assert table is spans.of(tr)
    inner = [table.spans[c[-1]][2] if c else None for c in table.chains]
    assert inner == [op[3] for op in OPS] * CALLS
    assert table.count["motion.gn_iter"] == 2 * CALLS
    assert table.count["step"] == CALLS
    us = lambda name: round(table.inclusive[name][0] * 1e6, 6)  # noqa: E731
    assert us("motion.gn_iter") == (5 + 10 + 2 + 1 + 8) * CALLS
    assert table.inclusive["motion.gn_iter"][1] == 5 * CALLS
    assert round(table.own["motion.gn_iter"][0] * 1e6, 6) == 1 * CALLS
    assert us("step") == (20 + 51 + 5) * CALLS
    # the stage spans hold exactly the operations of the hook ranges
    for stage in ("stereo", "motion", "fusion"):
        assert table.device_s(stage) == pytest.approx(tr.stage_s[stage], abs=0)


def test_gaps_split_in_step_and_boundary():
    table = spans.of(trace())
    # in a call: before the second gn.update (5), the second iteration's
    # update (7), fusion (2); between calls: the copy's gap (5) each
    # call, and the 902 us from the first call's copy to the second call
    assert round(table.step_idle_s * 1e6, 6) == (5 + 7 + 2) * CALLS
    assert round(table.boundary_idle_s * 1e6, 6) == 5 * CALLS + 902
    idle = {k: round(v * 1e6, 6) for k, v in table.idle.items()}
    assert idle == {"gn.update": 12 * CALLS, "fusion": 2 * CALLS, None: 5 * CALLS,
                    "stereo": 902}
    gaps = [(round(g * 1e6, 6), label, in_step) for g, label, in_step in table.gaps]
    assert [g[0] for g in gaps] == [902, 7, 7, 5, 5, 5, 5, 2, 2]
    assert sorted(gaps, key=str) == sorted(
        [(902, "stereo", False)] + CALLS * [(7, "gn.update", True), (5, "gn.update", True),
                                            (5, None, False), (2, "fusion", True)], key=str)


def test_readers():
    tr = trace()
    assert read("gn_iters_device_ms", tr) == pytest.approx(0.026, rel=1e-12)
    assert read("motion_encoders_device_ms", tr) == pytest.approx(0.022, rel=1e-12)
    assert read("gn_iter_launches", tr) == 2.5


@pytest.mark.parametrize("quantity", ["gn_iters_device_ms", "motion_encoders_device_ms",
                                      "gn_iter_launches"])
def test_readers_find_nothing_without_spans(quantity):
    bare = Trace(events(), CALLS, 0.002, "stream", [])
    assert read(quantity, bare) is None
    assert read(quantity, trace(with_codd=False)) is None


def test_trace_unchanged_by_codd_spans():
    with_spans = vars(Trace(events(True), CALLS, 0.002, "stream", []))
    without = vars(Trace(events(False), CALLS, 0.002, "stream", []))
    assert with_spans == without
    assert with_spans["stage_s"]["motion"] == pytest.approx(51e-6 * CALLS)
