"""Each cell's run, driven on the CPU at a tiny size (no card needed):
the program agrees with the reference within the cell's limits, the
lower-precision control does not, and a run whose timed path is broken
underneath reports ``correct`` false."""

import contextlib
import copy
import dataclasses
import io
import json
import time

import pytest
import torch

from perfbench.harness import compare, stream
from perfbench.harness.common import load_cell
from perfbench.harness.scenes import generator, stereo_clips

SEED = 2 ** 31 + 12345
STREAM_CELLS = ["kitti-stream-b4", "tartanair-stream-b16"]


def tiny(name):
    """The cell with its widths kept but its frames, batch, disparities
    and GN iterations cut to what a CPU test holds."""
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"]["stereo"]["initialization"]["max_disp"] = 32
    cfg["model"]["motion"]["iters"] = min(2, cfg["model"]["motion"]["iters"])
    tr = copy.deepcopy(cell.traffic)
    tr["scene"].update(object_depth_m=[3, 20], object_speed_px=2)
    tr.update(streams=2, frame=[60, 120], intrinsics=[60.0, 60.0, 60.0, 30.0], sequence_frames=3,
              check_sequence_among=1, check_frames=2, pool_sequences=1)
    cell.config, cell.traffic = cfg, tr
    return cell


def run_cell(cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert stream.run(cell, SEED, 1e-6, False, time.perf_counter(), device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def failed(checks):
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_program_agrees(name):
    res = run_cell(tiny(name))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in load_cell(name).end_to_end}


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_scene_views_agree_where_visible(name):
    """Each left pixel seen in the right view lies ``disparity`` whole
    pixels to its left there, with the same colour."""
    tr = load_cell(name).traffic
    h, w = tr["frame"]
    clip = stereo_clips(generator("cpu", SEED, "scene"), 2, 2, (h, w), tr["scene"],
                        tr["intrinsics"], "cpu", disparity=True)
    for t in range(2):
        d, dr = clip["disp"][t], clip["disp_right"][t]
        xr = torch.arange(w).view(1, 1, w) - d
        seen = (xr >= 0) & (torch.gather(dr, 2, xr.clamp(0, w - 1)) == d)
        right = torch.gather(clip["right"][t], 2, xr.clamp(0, w - 1)[..., None].expand(-1, -1, -1, 3))
        assert seen.float().mean() > 0.8
        assert torch.equal(right[seen], clip["left"][t][seen])
        assert len(torch.unique(d)) > 20   # the ground's rows and the boxes


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_stream_control_fails(name):
    cell = tiny(name)
    tr, dev = cell.traffic, torch.device("cpu")
    model = stream.program_model(cell.config, SEED, dev)
    pool = stream.make_pool(tr, SEED, dev)
    intr = torch.tensor([tr["intrinsics"]] * tr["streams"])
    seq, checked = stream.check_frames(tr, SEED)
    kept = stream.stream_calls(model, pool, intr, 0.0, seq, tr["sequence_frames"], checked)[3]
    ref = stream.reference_outputs(cell.config, pool[0], intr, SEED, dev, kept, checked)
    ctl = stream.reference_outputs(cell.config, pool[0], intr, SEED, dev, kept, checked,
                                   control=True)
    assert failed(compare.stream_checks(ctl, ref, tr["frame"], cell.limits))


def _stream_faults():
    from codd_torch.models import codd

    step = codd.CODD.step

    def unchanged(self, carry, *a, **k):
        return carry, step(self, carry, *a, **k)[1]

    def half_batch(self, carry, left, right, intr, **k):
        new, out = step(self, carry, left, right, intr, **k)
        h = left.shape[0] // 2
        for key in ("pred_disp", "pred_curr", "flow2d_est_induced"):
            out[key] = torch.cat([out[key][:h], out[key][:h]])[: left.shape[0]]
        return new, out

    def altered(self, *a, **k):
        new, out = step(self, *a, **k)
        out["pred_disp"] = out["pred_disp"].clone()
        out["pred_disp"][0] += 2.0
        return new, out

    def stale_memory(self, carry, *a, **k):
        # hands on the image and the disparity of the carry it was given
        new, out = step(self, carry, *a, **k)
        return dataclasses.replace(new, memory_img=carry.memory_img,
                                   memory_disp=carry.memory_disp), out

    return {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
            "stale_memory": stale_memory}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "stale_memory"])
@pytest.mark.parametrize("name", STREAM_CELLS)
def test_stream_fault_is_caught(name, fault, monkeypatch):
    from codd_torch.models import codd
    monkeypatch.setattr(codd.CODD, "step", _stream_faults()[fault])
    res = run_cell(tiny(name))
    assert not res["correct"]
    if fault == "stale_memory":   # the outputs agree: the reference runs from the stale carry
        assert "state_gap" in failed(res["checks"]), res["checks"]
