"""On the card, at each cell's own size: the lower-precision control (the
reference in TF32) fails the cell's limits on three seeds, and the
program passes them on the same seeds.  Marked ``gpu``; skips without a
card (decided in the fixture).  Run on the card:

    python -m pytest perfbench/tests/test_bench_card.py -m gpu -q"""

import pytest

from perfbench.harness.common import load_cell

SEEDS = (2 ** 31 - 7, 2 ** 31 + 101, 3 * 10 ** 9 + 5)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def failed(checks):
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kitti-stream-b4", "tartanair-stream-b16"])
def test_control_fails_program_passes(name, card):
    from perfbench.calibrate import stream_readings
    cell = load_cell(name)
    for seed in SEEDS:
        res = stream_readings(cell, seed, control=True, device=card)
        for side, fails in (("program", False), ("control", True)):
            checks = {k: {"value": res[side][k], "limit": lim} for k, lim in cell.limits.items()}
            assert bool(failed(checks)) == fails, (seed, side, checks)
