"""The port's profiler spans (``codd_torch/utils/spans.py``) on
``test_torch_codd.py``'s slice: CODD(max_disp=64, iters=2) at 64x128 on
the CPU, seeded weights, no JAX.

Without a profiler ``span`` is one shared null context and opens no
``record_function``; under a CPU ``torch.profiler`` a call emits the span
tree of the model (a root a call, the stages, RAFT-3D's parts, one
``codd.motion.gn_iter`` an iteration holding the three ``codd.gn.*``),
the outputs and carry stay the same bits, and the stage spans hold
exactly the host ops of the benchmark's hook ranges
(``perfbench/harness/trace.py:stage_ranges``)."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from codd_torch.models.builder import init_weights
from codd_torch.models.codd import CODD
from codd_torch.utils import spans

# one intra-op thread: each pytest-xdist worker is its own process
torch.set_num_threads(1)

B, H, W, ITERS = 1, 64, 128, 2
STAGES = ("stereo", "motion", "fusion")


@pytest.fixture(scope="module")
def slice_model():
    torch.manual_seed(0)
    model = CODD(max_disp=64, iters=ITERS)
    init_weights(model, 0)
    model.eval()
    gen = torch.Generator().manual_seed(1)
    frames = [(torch.rand(B, H, W, 3, generator=gen),
               torch.rand(B, H, W, 3, generator=gen)) for _ in range(2)]
    intr = torch.tensor([[100.0, 100.0, W / 2, H / 2]])
    with torch.no_grad():
        carry, _ = model.first_step(*frames[0], intr)
    return model, frames, intr, carry


def profiled(fn, tmp_path):
    """``fn()`` under a CPU profiler: (its result, the ``codd.`` spans and
    the host ops, each a (start us, end us, name) list sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def of(cat, prefix=""):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == cat and e["name"].startswith(prefix))
    return res, of("user_annotation", spans.PREFIX), of("cpu_op"), \
        of("user_annotation")


def tree(ranges):
    """Nested ranges -> [(name, children)] by containment."""
    root = ("", [])
    stack = [(float("inf"), root)]
    for t0, t1, name in ranges:
        while stack[-1][0] < t0:
            stack.pop()
        node = (name, [])
        stack[-1][1][1].append(node)
        stack.append((t1, node))
    return root[1]


def names(nodes):
    return [n for n, _ in nodes]


def inside(ranges, t0, t1):
    return [r for r in ranges if t0 <= r[0] and r[1] <= t1]


def step(model, frames, intr, carry):
    with torch.no_grad():
        return model.step(carry, *frames[1], intr)


def test_no_profiler_no_record_function(slice_model, monkeypatch):
    model, frames, intr, carry = slice_model
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    assert spans.span("step") is spans._NULL
    assert spans.span("motion") is spans.span("fusion")
    step(model, frames, intr, carry)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("step"), real)
    assert opened == [("codd.step",)]


def test_step_span_tree(slice_model, tmp_path):
    model, frames, intr, carry = slice_model
    _, sp, ops, _ = profiled(lambda: step(model, frames, intr, carry),
                             tmp_path)
    (root,) = tree(sp)
    assert root[0] == "codd.step"
    kids = dict(root[1])
    assert names(root[1]) == ["codd.stereo", "codd.motion", "codd.project",
                              "codd.fusion"]
    assert names(kids["codd.stereo"]) == [
        "codd.stereo.backbone", "codd.stereo.init", "codd.stereo.propagate"]
    motion = kids["codd.motion"]
    assert names(motion) == (["codd.motion.features"]
                             + ["codd.motion.gn_iter"] * ITERS
                             + ["codd.motion.upsample", "codd.motion.context",
                                "codd.motion.splat"])
    for name, gn in motion:
        want = (["codd.gn.lookup", "codd.gn.update", "codd.gn.solve"]
                if name == "codd.motion.gn_iter" else [])
        assert names(gn) == want, name
        assert all(not c for _, c in gn)
    assert kids["codd.project"] == [] and kids["codd.fusion"] == []
    # every host op of the call runs inside its root
    (r0, r1, _), = [s for s in sp if s[2] == "codd.step"]
    assert ops and all(r0 <= t0 and t1 <= r1 for t0, t1, _ in ops)
    # each GN part launches work of its own
    for t0, t1, name in sp:
        if name.startswith(("codd.gn.", "codd.motion.", "codd.stereo.")):
            assert inside(ops, t0, t1), name


def test_first_step_span_tree(slice_model, tmp_path):
    model, frames, intr, _ = slice_model

    def first():
        with torch.no_grad():
            return model.first_step(*frames[0], intr)
    _, sp, _, _ = profiled(first, tmp_path)
    (root,) = tree(sp)
    assert root[0] == "codd.first_step"
    assert names(root[1]) == ["codd.stereo", "codd.motion.encode",
                              "codd.project"]
    assert names(dict(root[1])["codd.stereo"]) == [
        "codd.stereo.backbone", "codd.stereo.init", "codd.stereo.propagate"]


def test_profiler_keeps_bits(slice_model, tmp_path):
    model, frames, intr, carry = slice_model
    carry0, out0 = step(model, frames, intr, carry)
    (carry1, out1), sp, _, _ = profiled(
        lambda: step(model, frames, intr, carry), tmp_path)
    assert sp
    assert out0.keys() == out1.keys()
    for k in out0:
        assert torch.equal(out0[k], out1[k]), k
    for k in ("memory_img", "memory_feat", "memory_disp", "fmap", "netinp",
              "kalman_p"):
        assert torch.equal(getattr(carry0, k), getattr(carry1, k)), k


def test_stage_spans_match_hook_ranges(slice_model, tmp_path):
    from perfbench.harness.trace import STAGE_PREFIX, stage_ranges
    model, frames, intr, carry = slice_model

    def hooked():
        with stage_ranges({s: getattr(model, s) for s in STAGES}):
            return step(model, frames, intr, carry)
    _, sp, ops, annotations = profiled(hooked, tmp_path)
    for stage in STAGES:
        (p0, p1, _), = [a for a in annotations
                        if a[2] == STAGE_PREFIX + stage]
        (c0, c1, _), = [s for s in sp if s[2] == spans.PREFIX + stage]
        assert c0 <= p0 and p1 <= c1
        held = inside(ops, p0, p1)
        assert held and inside(ops, c0, c1) == held, stage


def test_training_opens_gn_iter_spans_in_checkpointed_branch(slice_model,
                                                             tmp_path):
    model, frames, intr, carry = slice_model

    def train_step():
        _, out = model.step(carry, *frames[1], intr, train=True)
        assert len(out["flow2d_est"]) == ITERS
        sum(e.sum() for e in out["flow2d_est"]).backward()
    try:
        _, sp, _, _ = profiled(train_step, tmp_path)
    finally:
        model.zero_grad(set_to_none=True)
    (root,) = [n for n in tree(sp) if n[0] == "codd.step"]
    motion = dict(root[1])["codd.motion"]
    iters = [c for n, c in motion if n == "codd.motion.gn_iter"]
    assert len(iters) == ITERS
    assert all(names(c) == ["codd.gn.lookup", "codd.gn.update",
                            "codd.gn.solve"] for c in iters)
    # the backward recomputes each checkpointed iteration: its GN parts
    # open again after the call, outside any gn_iter span
    (_, r1, _), = [s for s in sp if s[2] == "codd.step"]
    again = [s for s in sp if s[0] > r1]
    assert [s[2] for s in again].count("codd.gn.lookup") == ITERS
