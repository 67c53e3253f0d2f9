"""A streaming cell: ``streams`` stereo rigs batched in one call of
``CODD.first_step`` / ``CODD.step``, closed loop: each call starts when
the last one's fused disparity has reached the host.

Set-up: the model from the configuration (``build_estimator``) with
seeded weights, a pool of ``pool_sequences`` seeded sequences of
``sequence_frames`` frames on the card, and one warm-up (``first_step``
and two ``step`` calls at the cell's shapes).  The window then streams
sequence after sequence (sequence s is pool entry s mod the pool's size)
for ``--seconds``.  Before the window the seed draws one of the first
``check_sequence_among`` sequences to compare; the outputs of its calls
are kept, and if the window closes before it completes, its remaining
calls run after the close, outside the timing.

The comparison: the reference (``perfbench/reference``, the port's plain
path frozen, on the card), with the same weights drawn again from the
seed, runs each checked frame from the carry the program handed that
call, and ``compare.stream_checks`` holds each frame's stereo disparity,
motion flow, fused disparity and the carry the call made to the limits
of ``perfbench/limits/<workload>.json``."""

from __future__ import annotations

import contextlib
import gc
import random
import sys
import time
from typing import Dict, List

import torch

from . import compare
from .control import lower_precision
from .common import Cell, empty_cache, report, sync
from .reference_model import reference_model
from .scenes import generator, stereo_clips, sub_seed
from .weights import make_state

__all__ = ["run", "program_model", "make_pool", "stream_calls", "reference_outputs"]

def program_model(config: Dict, seed: int, device):
    """The port's model of ``config`` on ``device`` with the seed's weights."""
    from codd_torch.models.builder import build_estimator
    model = build_estimator(config["model"], device=device, seed=None)
    with torch.device("meta"):
        skeleton = reference_model(config["model"])
    model.load_state_dict(make_state(skeleton, seed, device))
    return model


def make_pool(traffic: Dict, seed: int, device) -> List[Dict]:
    return [stereo_clips(generator(device, seed, "sequence", s), traffic["streams"],
                         traffic["sequence_frames"], traffic["frame"], traffic["scene"],
                         traffic["intrinsics"], device, traffic["pad_divisor"])
            for s in range(traffic["pool_sequences"])]


def _call(model, carry, clip, f, intr):
    if f == 0:
        return model.first_step(clip["left"][0], clip["right"][0], intr)
    return model.step(carry, clip["left"][f], clip["right"][f], intr)


def _kept(out, fused_host, f, carry_in, carry_out) -> Dict:
    """What the comparison reads of one call: the stereo disparity (frame
    0's output is the stereo's), the motion flow, the fused disparity, the
    state the call was given and the state it made."""
    kept = {"fused": fused_host, "carry_in": carry_in,
            "state": {k: getattr(carry_out, k) for k in compare.CARRY}}
    if f == 0:
        kept["stereo"] = out["pred_disp"]
    else:
        kept["stereo"] = out["pred_curr"]
        kept["flow"] = out["flow2d_est_induced"]
    return kept


def check_frames(traffic: Dict, seed: int):
    """The checked sequence and its checked frames, drawn from the seed:
    frame 0 (the start) and ``check_frames`` of the later ones."""
    rng = random.Random(sub_seed(seed, "check"))
    seq = rng.randrange(traffic["check_sequence_among"])
    later = sorted(rng.sample(range(1, traffic["sequence_frames"]), traffic["check_frames"]))
    return seq, [0] + later


def _to_host(x: torch.Tensor, buf):
    """``x`` copied into ``buf`` on the host (page-locked where ``x`` is on
    the card; made at the first call), waiting for the copy."""
    if buf is None:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    buf.copy_(x)
    return buf


def stream_calls(model, pool, intr, seconds: float, check_seq: int, frames: int,
                 checked: List[int]):
    """The closed loop for ``seconds``: (latencies s, window s, calls,
    kept outputs of the checked frames of sequence ``check_seq``)."""
    lat, kept = [], {}
    carry = None
    call = 0
    host = None   # the fused disparity's page-locked buffer on the host
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t1 = t_start
    with torch.no_grad():
        while t1 < deadline:
            s, f = divmod(call, frames)
            t0 = time.perf_counter()
            given = carry
            carry, out = _call(model, carry, pool[s % len(pool)], f, intr)
            host = _to_host(out["pred_disp"], host)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if s == check_seq and f in checked:
                kept[f] = _kept(out, host.clone(), f, given, carry)
            call += 1
        window = t1 - t_start
        # the checked frames still due after the close, untimed
        while len(kept) < len(checked):
            s, f = divmod(call, frames)
            given = carry
            carry, out = _call(model, carry, pool[s % len(pool)], f, intr)
            if s == check_seq and f in checked:
                kept[f] = _kept(out, out["pred_disp"].cpu(), f, given, carry)
            call += 1
    return lat, window, len(lat), [kept[f] for f in checked]


def reference_outputs(config: Dict, clip: Dict, intr, seed: int, device, kept: List[Dict],
                      checked: List[int], control: bool = False) -> List[Dict]:
    """The reference, with the seed's weights, on each checked frame: frame
    0 from the frames alone; a later frame f from the state the program
    handed to that call (the stream is recurrent, and the reference
    follows the program's own state step by step).  With ``control``, its
    products in TF32."""
    from perfbench.reference.models.codd import CoddCarry
    ref = reference_model(config["model"]).to(device).eval()
    ref.load_state_dict(make_state(ref, seed, device))
    outs = []
    with torch.no_grad(), (lower_precision(device) if control else contextlib.nullcontext()):
        for f, k in zip(checked, kept):
            given = None if f == 0 else CoddCarry(**{
                name: getattr(k["carry_in"], name) for name in compare.CARRY})
            carry, out = _call(ref, given, clip, f, intr)
            outs.append(_kept(out, out["pred_disp"], f, None, carry))
    return outs


def _trace(model, pool, intr, calls: int):
    """``calls`` ``step`` calls of a fresh sequence under the profiler, each
    stage in a range of its own."""
    from .trace import stage_ranges, traced
    from codd_torch.ops import kernels
    clip = pool[0]
    with torch.no_grad():
        carry, _ = _call(model, None, clip, 0, intr)

        def run():
            nonlocal carry
            kernels.reset_counts()
            with torch.no_grad(), stage_ranges({"stereo": model.stereo,
                                                "motion": getattr(model, "motion", None),
                                                "fusion": getattr(model, "fusion", None)}):
                for f in range(1, calls + 1):
                    carry, out = _call(model, carry, clip, f, intr)
                    out["pred_disp"].cpu()
            return calls

        tr = traced(run, "stream")
    tr.counts = {k: v for k, v in kernels.counts().items() if v}
    return tr


def _work(config: Dict, clip: Dict, intr, seed: int, device) -> Dict:
    """One ``step`` call of the reference at the cell's shapes, counted."""
    from .work import counted_work
    ref = reference_model(config["model"]).to(device).eval()
    ref.load_state_dict(make_state(ref, seed, device))
    with torch.no_grad():
        carry, _ = _call(ref, None, clip, 0, intr)
        with counted_work("perfbench.reference") as work:
            _call(ref, carry, clip, 1, intr)
    return work.as_dict()


def _step_call_s(lat: List[float], frames: int) -> float:
    """Mean seconds of the window's ``step`` calls (every call but each
    sequence's first)."""
    steps = [t for i, t in enumerate(lat) if i % frames]
    return sum(steps) / len(steps) if steps else float("nan")


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda") -> int:
    """One run of the cell; prints the result.  ``device`` "cpu" drives
    the same run without a card (tests; no trace there).  Set-up's parts
    are printed on stderr."""
    dev = torch.device(device)
    tr = cell.traffic
    B, L = tr["streams"], tr["sequence_frames"]
    marks = [("start", t_process), ("imports", time.perf_counter())]
    model = program_model(cell.config, seed, dev)
    sync(dev)
    marks.append(("model", time.perf_counter()))
    pool = make_pool(tr, seed, dev)
    intr = torch.tensor([tr["intrinsics"]] * B, device=dev)
    check_seq, checked = check_frames(tr, seed)
    sync(dev)
    marks.append(("frames", time.perf_counter()))
    with torch.no_grad():   # every shape the window uses
        carry, _ = _call(model, None, pool[0], 0, intr)
        for f in (1, 2):
            carry, out = _call(model, carry, pool[0], f, intr)
        out["pred_disp"].cpu()
    del carry, out
    sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_process
    print("set-up s: " + ", ".join(f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1)
                                   in zip(marks, marks[1:])), file=sys.stderr, flush=True)

    lat, window, calls, kept = stream_calls(model, pool, intr, seconds, check_seq, L, checked)
    tr_ = _trace(model, pool, intr, tr["trace_calls"]) if trace else None
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    clip = pool[check_seq % len(pool)]
    del model
    pool = None
    gc.collect()
    empty_cache(dev)

    ref = reference_outputs(cell.config, clip, intr, seed, dev, kept, checked)
    checks = compare.stream_checks(kept, ref, tr["frame"], cell.limits)
    if trace:
        tr_.work = _work(cell.config, clip, intr, seed, dev)
        tr_.call_s = _step_call_s(lat, L)
    report(cell, dev, calls, peak, checks,
           values={"frames_per_s": calls * B / window,
                   "frame_ms_p90": compare.percentile(lat, 90) * 1e3, "setup_s": setup_s},
           trace=tr_)
    return 0
