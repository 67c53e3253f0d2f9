"""The readings that the limits of ``perfbench/limits/<workload>.json``
are set from, at the cell's own size, many seeds in one process.

    python3 perfbench/calibrate.py --workload NAME --seeds 11 12 13 ... [--control]

For each seed, as a run of the cell makes them: the program's numbers
against the reference and, with ``--control``, the lower-precision
control's (the reference in TF32) against the reference.  One JSON line
a seed and source."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def stream_readings(cell, seed: int, control: bool, device="cuda"):
    import torch
    from perfbench.harness import compare, stream
    tr = cell.traffic
    model = stream.program_model(cell.config, seed, device)
    pool = stream.make_pool(tr, seed, device)
    intr = torch.tensor([tr["intrinsics"]] * tr["streams"], device=device)
    check_seq, checked = stream.check_frames(tr, seed)
    _, _, _, kept = stream.stream_calls(model, pool, intr, 0.0, check_seq,
                                        tr["sequence_frames"], checked)
    clip = pool[check_seq % len(pool)]
    del model
    out = {}
    ref = stream.reference_outputs(cell.config, clip, intr, seed, device, kept, checked)
    out["program"] = compare.stream_values(kept, ref, tr["frame"])
    if control:
        ctl = stream.reference_outputs(cell.config, clip, intr, seed, device, kept, checked,
                                       control=True)
        out["control"] = compare.stream_values(ctl, ref, tr["frame"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    from perfbench.harness.common import card_name_power, load_cell
    cell = load_cell(args.workload)
    print(json.dumps({"card": card_name_power()}), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = stream_readings(cell, seed, args.control)
        for source, checks in res.items():
            print(json.dumps({"workload": cell.name, "seed": seed, "source": source,
                              "readings": checks,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
