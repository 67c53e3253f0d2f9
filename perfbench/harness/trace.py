"""The traced window: ``torch.profiler`` (CUPTI) over a few calls, with a
``record_function`` range around each stage opened by forward hooks from
here (the program is not edited), reduced to what the per-layer readers
take.

From the exported Chrome trace: every device operation (kernels, copies,
fills) with its start and length, the host's runtime call that launched
it (by correlation id) and the innermost stage range around that call,
and the host ops running at each moment (for the idle gaps)."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Trace", "stage_ranges", "traced", "hand_kernel_names"]

STAGE_PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def hand_kernel_names() -> List[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    import codd_torch
    csrc = Path(codd_torch.__file__).resolve().parent / "csrc"
    names = set()
    for src in csrc.glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(",
            src.read_text()))
    return sorted(names)


@contextlib.contextmanager
def stage_ranges(modules: Dict[str, torch.nn.Module]):
    """A ``record_function`` range named ``perfbench.<stage>`` around each
    forward of each module, by forward pre- and post-hooks."""
    handles, open_ = [], {}

    def pre(name):
        def hook(mod, args, kwargs=None):
            rf = torch.profiler.record_function(STAGE_PREFIX + name)
            rf.__enter__()
            open_.setdefault(name, []).append(rf)
        return hook

    def post(name):
        def hook(mod, args, out):
            open_[name].pop().__exit__(None, None, None)
        return hook

    for name, mod in modules.items():
        if mod is None:
            continue
        handles.append(mod.register_forward_pre_hook(pre(name)))
        handles.append(mod.register_forward_hook(post(name)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


class Trace:
    """The reduced trace of ``calls`` calls over ``window_s`` seconds.

    The profiler slows the host (it records every host op), so a share of
    the traced window's host time reads the profiler too.  ``call_s``, set
    by the runner, is the mean host-clock seconds of the same kind of call
    in the untraced window: the time base of the shares of a call's time."""

    def __init__(self, events: List[Dict], calls: int, window_s: float,
                 kind: str, hand: List[str]):
        self.calls, self.window_s, self.kind = calls, window_s, kind
        self.call_s: Optional[float] = None
        self.work: Dict = {}
        self.counts: Dict[str, int] = {}
        runtime = {}
        annotations, host_ops = [], []
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                device.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    runtime[corr] = e
            elif cat == "user_annotation" and e["name"].startswith(STAGE_PREFIX):
                annotations.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                    e["name"][len(STAGE_PREFIX):]))
            elif cat == "cpu_op":
                host_ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        device.sort(key=lambda e: float(e["ts"]))
        annotations.sort()
        hand_re = re.compile("|".join(re.escape(n) for n in hand)) if hand else None
        self.ops = []   # (name, start us, dur us, stage or None, hand kernel?, launcher ts)
        for e in device:
            launch = runtime.get(e.get("args", {}).get("correlation"))
            lts = float(launch["ts"]) if launch is not None else None
            stage = None
            if lts is not None:
                for a0, a1, name in annotations:
                    if a0 <= lts <= a1:
                        stage = name   # innermost: the last that contains it
                    elif a0 > lts:
                        break
            is_hand = bool(hand_re and e.get("cat") == "kernel" and hand_re.search(e["name"]))
            self.ops.append((e["name"], float(e["ts"]), float(e["dur"]), stage, is_hand, lts))
        self.launches = len(self.ops)
        # busy: the union of the device operations' intervals
        busy, end = 0.0, None
        for _, t0, d, *_ in self.ops:
            t1 = t0 + d
            if end is None or t0 >= end:
                busy += d
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        self.busy_s = busy * 1e-6
        self.stage_s: Dict[str, float] = {}
        self.hand_s = 0.0
        by_name: Dict[str, float] = {}
        for name, _, d, stage, is_hand, _ in self.ops:
            if stage is not None:
                self.stage_s[stage] = self.stage_s.get(stage, 0.0) + d * 1e-6
            if is_hand:
                self.hand_s += d * 1e-6
            by_name[name] = by_name.get(name, 0.0) + d * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        # idle gaps, labelled by the host op that launched the operation after them
        host_ops.sort()
        starts = [h[0] for h in host_ops]
        gaps = []
        end = None
        for name, t0, d, stage, _, lts in self.ops:
            if end is not None and t0 > end:
                label = "unknown"
                if lts is not None:
                    i = bisect.bisect_right(starts, lts)
                    for j in range(i - 1, max(i - 200, -1), -1):
                        h0, h1, hname = host_ops[j]
                        if h0 <= lts <= h1:
                            label = hname
                            break
                gaps.append((label, (t0 - end) * 1e-6))
            end = max(end or 0.0, t0 + d)
        gaps.sort(key=lambda g: -g[1])
        self.idle_gaps = gaps[:10]

    def breakdown(self) -> Dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}


def traced(run_calls: Callable[[], int], kind: str,
           tmpdir: Optional[str] = None) -> Trace:
    """Profile ``run_calls()`` (which makes the calls, synchronises and
    returns how many it made) and reduce its trace; the window is the host
    clock's span of ``run_calls``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = run_calls()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, calls, window_s, kind, hand_kernel_names())
