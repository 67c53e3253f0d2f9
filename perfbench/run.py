"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout of the repository, on a machine with as many
CUDA cards as the cell asks for.  ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
window; both check the outputs of the timed calls against the plain
reference.  The last line of standard output is the result (JSON).
Exits non-zero, with no result, without the cards, without the program
(``codd_torch``) beside this folder, or when a module of JAX or of the
JAX package was loaded."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the kernels build into the checkout (codd_torch/ops/kernels.py puts
    # them under build/); no library the run loads may pull in JAX
    os.environ.setdefault("USE_FLAX", "0")
    # one process with one host thread for the operators' own work: the
    # launching thread does not share the cores with a thread pool
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.common import load_cell
    cell = load_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import codd_torch  # noqa: F401  (fails here in a tree without the program)
    kind = cell.traffic["kind"]
    if kind != "stream":
        print(f"perfbench: unknown traffic kind {kind!r}", file=sys.stderr)
        return 2
    from perfbench.harness import stream
    return stream.run(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
