"""What every cell shares: the benchmark's files found by name, the card
checks, the result line and the check that no JAX module was loaded."""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
# top-level module names the measured process may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "codd_tpu")

__all__ = ["ROOT", "BENCH", "FORBIDDEN", "Cell", "load_cell", "forbidden_modules",
           "device_info", "sync", "empty_cache", "card_name_power", "emit", "base_name",
           "metric_readers", "report"]


class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with its files: the
    configuration, the traffic mix and the limits of its comparison."""

    def __init__(self, manifest: Dict, name: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"perfbench: no workload {name!r}; known: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads((ROOT / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]


def load_cell(name: str) -> Cell:
    return Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)


def base_name(name: str) -> str:
    """A metric's quantity: its name up to the first dot (``frames_per_s``
    of ``frames_per_s.kitti-stream-b4``)."""
    return name.split(".", 1)[0]


def metric_readers(metrics: List[Dict]):
    """name -> ``read(trace)`` of ``perfbench/metrics/<name>.py``, or where
    there is no such file, of the quantity's ``<base_name>.py``."""
    readers = {}
    for m in metrics:
        path = BENCH / "metrics" / f"{m['name']}.py"
        if not path.exists():
            path = BENCH / "metrics" / f"{base_name(m['name'])}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + m["name"].replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[m["name"]] = (m, mod.read)
    return readers


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def empty_cache(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_info(device, count: int, peak_bytes: int, busy_s: Optional[float] = None,
                window_s: Optional[float] = None) -> Dict:
    import torch
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": count, "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        info["busy_s"] = busy_s
        info["window_s"] = window_s
    return info


def _finite(x):
    """A number JSON can carry: a non-finite one as its name."""
    return x if math.isfinite(x) else repr(x)


def emit(correct: bool, attempted: int, failed: int, metrics: Dict,
         device: Dict, checks: Dict, breakdown: Optional[Dict] = None) -> None:
    """The checks on stderr as the last lines there, then the result as
    the last line of stdout, the checks last in it.  Prints no result,
    and exits 3, where a module of JAX or of the JAX package was loaded."""
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules that may not load were loaded: {found}",
              file=sys.stderr, flush=True)
        sys.exit(3)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    checks = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
              for k, c in checks.items()}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)


def report(cell: Cell, device, attempted: int, peak: int, checks: Dict,
           values: Optional[Dict] = None, trace=None) -> None:
    """Print a run's result: ``correct`` from the checks against their
    limits; the cell's end-to-end metrics from ``values`` (keyed by
    quantity, ``base_name``), or with a ``trace`` the per-layer metrics its
    readers find and its breakdown."""
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace is None:
        metrics = {m["name"]: {"value": values[base_name(m["name"])], "unit": m["unit"]}
                   for m in cell.end_to_end}
        emit(correct, attempted, 0, metrics, device_info(device, cell.chips, peak), checks)
        return
    metrics = {}
    for name, (m, read) in metric_readers(cell.per_layer).items():
        value = read(trace)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    emit(correct, attempted, 0, metrics,
         device_info(device, cell.chips, peak, trace.busy_s, trace.window_s), checks,
         trace.breakdown())
