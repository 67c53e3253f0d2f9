"""BENCHMARK.json resolves to the benchmark's own files, and they keep the
contract's shapes."""

import json
import re

import pytest

from perfbench.harness.common import BENCH, ROOT, base_name, load_cell, metric_readers

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert isinstance(data["assumed"], list) and data["source_line"]
    assert data["iters"] == data["model"]["motion"]["iters"]


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    c = load_cell(cell["name"])
    assert c.chips == 1
    assert c.traffic["kind"] == "stream"
    assert set(c.limits) and all(isinstance(v, (int, float)) for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    readers = metric_readers(c.per_layer)
    assert readers and all(callable(r) for _, r in readers.values())
    assert all(m["moves"] in e2e for m in c.per_layer)


def test_names_units_and_files():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert any((BENCH / "metrics" / f"{n}.py").exists() for n in (m["name"], base_name(m["name"])))
        # every cell that reads the metric reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024
