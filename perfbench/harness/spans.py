"""The program's own spans in a traced window, reduced.

``codd_torch/utils/spans.py`` opens a ``record_function`` range named
``codd.<name>`` at each layer boundary while a profiler records (a
call's root ``codd.step`` / ``codd.first_step``, the stages, RAFT-3D's
parts, one ``codd.motion.gn_iter`` a GN iteration).  They are
``user_annotation`` events of the same Chrome trace as the device
operations, on one clock, and nest on the one launching thread.

``collect(events)`` keeps them; ``SpanTable(spans, ops)`` attributes each
device operation of ``Trace.ops`` to the spans around the host call that
launched it (its ``lts``) and sums, by span name:

* ``inclusive``: device seconds and launches of the operations launched
  anywhere inside a span of that name, its children's included;
* ``own``: the same for the operations whose innermost span it is;
* ``count``: the spans of that name (``motion.gn_iter``: the iterations);
* ``idle``: the device's idle gaps (as ``Trace`` finds them), each
  labelled by the innermost span around the launch of the operation
  after it; ``step_idle_s`` sums the gaps whose operations on both sides
  were launched inside one ``codd.step`` span (the device waiting while
  the program launched a call), ``boundary_idle_s`` the rest (between
  calls: the output's copy, the loop); ``gaps`` lists each gap as
  (seconds, label, in a step), longest first.  The traced window's host
  runs under the profiler, which adds its own time to each launch, so the
  idle split labels where the device waited, not how long it waits with
  the profiler off.

``of(trace)`` is the table of a ``Trace`` that carries ``spans`` (the
list ``collect`` makes), or None: the readers of the span metrics find
nothing in a trace without them."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from codd_torch.utils.spans import PREFIX

__all__ = ["ROOT", "collect", "SpanTable", "of"]

ROOT = "step"

Span = Tuple[float, float, str]


def collect(events: Iterable[Dict]) -> List[Span]:
    """The ``codd.`` ranges of a Chrome trace's events: (start us, end us,
    name without the prefix), sorted by start, a parent before a child
    that starts with it."""
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith(PREFIX)):
            t0 = float(e["ts"])
            out.append((t0, t0 + float(e["dur"]), e["name"][len(PREFIX):]))
    out.sort(key=lambda s: (s[0], -s[1]))
    return out


def chains(spans: List[Span], times: List[Optional[float]]) -> List[Tuple[int, ...]]:
    """For each time, the indices into ``spans`` (sorted as ``collect``
    sorts them, properly nested) of the spans open then, outermost first;
    () for a time of None."""
    out: List[Tuple[int, ...]] = [()] * len(times)
    stack: List[int] = []
    i = 0
    for k in sorted((k for k, t in enumerate(times) if t is not None),
                    key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[k] = tuple(stack)
    return out


class SpanTable:
    """Device time, launches and idle gaps by span; see the module."""

    def __init__(self, spans: List[Span], ops: List[Tuple]):
        self.spans = spans
        self.count: Dict[str, int] = {}
        for _, _, name in spans:
            self.count[name] = self.count.get(name, 0) + 1
        self.inclusive: Dict[str, List[float]] = {}   # name -> [device s, launches]
        self.own: Dict[str, List[float]] = {}
        lts = [op[5] for op in ops]
        self.chains = chains(spans, lts)
        for op, chain in zip(ops, self.chains):
            d = op[2] * 1e-6
            for name in {spans[j][2] for j in chain}:
                acc = self.inclusive.setdefault(name, [0.0, 0])
                acc[0] += d
                acc[1] += 1
            if chain:
                acc = self.own.setdefault(spans[chain[-1]][2], [0.0, 0])
                acc[0] += d
                acc[1] += 1
        # the idle gaps as Trace finds them (ops sorted by device start)
        self.idle: Dict[Optional[str], float] = {}
        self.step_idle_s = self.boundary_idle_s = 0.0
        self.gaps: List[Tuple[float, Optional[str], bool]] = []
        end, before = None, None
        for k, (_, t0, d, *_) in enumerate(ops):
            if end is not None and t0 > end:
                gap = (t0 - end) * 1e-6
                after = self.chains[k]
                label = spans[after[-1]][2] if after else None
                self.idle[label] = self.idle.get(label, 0.0) + gap
                step = self._step(after)
                in_step = step is not None and step == self._step(self.chains[before])
                if in_step:
                    self.step_idle_s += gap
                else:
                    self.boundary_idle_s += gap
                self.gaps.append((gap, label, in_step))
            if end is None or t0 + d > end:
                end, before = t0 + d, k
        self.gaps.sort(key=lambda g: -g[0])

    def _step(self, chain: Tuple[int, ...]) -> Optional[int]:
        """The ``codd.step`` span (its index) a chain lies in, or None."""
        for j in chain:
            if self.spans[j][2] == ROOT:
                return j
        return None

    def device_s(self, name: str) -> Optional[float]:
        return self.inclusive[name][0] if name in self.inclusive else None

    def launches(self, name: str) -> Optional[int]:
        return self.inclusive[name][1] if name in self.inclusive else None


def of(trace) -> Optional[SpanTable]:
    """The span table of a stream cell's ``trace``, made once, or None
    where the trace carries no ``codd.`` spans."""
    spans = getattr(trace, "spans", None)
    if trace.kind != "stream" or not trace.calls or not spans:
        return None
    table = getattr(trace, "span_table", None)
    if table is None:
        table = trace.span_table = SpanTable(spans, trace.ops)
    return table
