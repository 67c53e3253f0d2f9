"""A cell's traced window broken down by the program's ``codd.`` spans.

    python3 perfbench/span_table.py --workload NAME --seed N [--out FILE.json]

From the root of a checkout, on a CUDA card.  Builds the cell's model and
frames and warms up as ``perfbench/run.py`` does, then runs the traced
window of ``run.py --trace 1`` (``stream._trace``: the stage hooks, the
cell's ``trace_calls`` ``step`` calls).  ``Trace`` does not keep the
``codd.`` spans yet, so ``traced`` is handed one that does.  Prints, per
call, ``spans.of(trace)`` by span name: spans, device ms (inclusive, and
of the operations whose innermost span it is), launches and idle ms
labelled by the span of the operation after the gap; then the hooks'
stage times beside the spans of the same stages, motion's children's
cover, the idle split, the longest gaps and the span metrics' readers.
The JSON of all of it goes to ``--out``.

Once ``Trace`` keeps the spans itself, ``run.py --trace 1`` reports the
span metrics and this script can go."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MOTION_PARTS = ("motion.features", "motion.gn_iter", "motion.upsample",
                "motion.context", "motion.splat")
SPAN_METRICS = ("gn_iters_device_ms", "motion_encoders_device_ms", "gn_iter_launches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from perfbench.harness import spans, stream, trace as trace_mod
    from perfbench.harness.common import card_name_power, load_cell, metric_readers

    class SpanTrace(trace_mod.Trace):
        """``Trace`` that keeps the ``codd.`` spans too."""

        def __init__(self, events, *args):
            super().__init__(events, *args)
            self.spans = spans.collect(events)

    trace_mod.Trace = SpanTrace

    cell = load_cell(args.workload)
    tr = cell.traffic
    dev = torch.device("cuda")
    model = stream.program_model(cell.config, args.seed, dev)
    pool = stream.make_pool(tr, args.seed, dev)
    intr = torch.tensor([tr["intrinsics"]] * tr["streams"], device=dev)
    with torch.no_grad():   # every shape the window uses, as run.py warms up
        carry, _ = stream._call(model, None, pool[0], 0, intr)
        for f in (1, 2):
            carry, out = stream._call(model, carry, pool[0], f, intr)
        out["pred_disp"].cpu()
    del carry, out
    n = tr["trace_calls"]
    trace = stream._trace(model, pool, intr, n)
    table = spans.of(trace)
    if table is None:
        print("perfbench: no codd. span in the traced window", file=sys.stderr)
        return 1
    per = 1e3 / n
    rows = {}
    for name in sorted(table.count, key=lambda s: min(t0 for t0, _, m in table.spans if m == s)):
        inc = table.inclusive.get(name, [0.0, 0])
        rows[name] = {"spans": table.count[name] / n, "device_ms": inc[0] * per,
                      "own_ms": table.own.get(name, [0.0])[0] * per, "launches": inc[1] / n,
                      "idle_ms": table.idle.get(name, 0.0) * per}
    motion = table.device_s("motion") or 0.0
    cover = sum(table.device_s(p) or 0.0 for p in MOTION_PARTS)
    result = {
        "workload": cell.name, "seed": args.seed, "card": card_name_power(),
        "torch": torch.__version__, "calls_traced": n, "window_ms": trace.window_s * per,
        "busy_ms": trace.busy_s * per, "launches": trace.launches / n,
        "stages": {s: {"hooks_ms": trace.stage_s.get(s, 0.0) * per,
                       "span_ms": (table.device_s(s) or 0.0) * per}
                   for s in ("stereo", "motion", "fusion")},
        "motion_children_share": cover / motion if motion else None,
        "idle_ms": {"in_step": table.step_idle_s * per, "boundary": table.boundary_idle_s * per,
                    "unlabelled": table.idle.get(None, 0.0) * per},
        "longest_gaps_ms": [[g * 1e3, label, in_step] for g, label, in_step in table.gaps[:12]],
        "metrics": {name: read(trace) for name, (_, read)
                    in metric_readers([{"name": q} for q in SPAN_METRICS]).items()},
        "spans": rows,
    }
    print(f"{cell.name} seed {args.seed}, {result['card']}, per call ({n} traced step calls)")
    print(f"{'span':24s} {'n':>5s} {'device ms':>10s} {'own ms':>9s} {'launches':>9s} "
          f"{'idle ms':>8s}")
    for name, r in rows.items():
        print(f"{name:24s} {r['spans']:5.1f} {r['device_ms']:10.3f} {r['own_ms']:9.3f} "
              f"{r['launches']:9.1f} {r['idle_ms']:8.3f}")
    print(json.dumps({k: v for k, v in result.items() if k != "spans"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
