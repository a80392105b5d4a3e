"""The benchmark's run of one cell, driven by data.

Everything is found by name from ``BENCHMARK.json``:

* the cell's configuration file (its ``file``) and its traffic mix,
  ``gnnbench/traffic/<traffic>.json``, whose ``driver`` names
  ``gnnbench/drivers/<driver>.py``;
* every per-layer metric's reader, ``gnnbench/metrics/<name>.py``, a
  function ``read(record)`` that returns the number or None when the
  traced run holds nothing for it to read;
* the limits of the numbers that decide ``correct``,
  ``gnnbench/limits/<workload>.json``.

A driver's ``run(cfg, traffic, seed, seconds, trace, device, t_start)``
returns ``e2e`` (with ``--trace 0``) or ``record`` (with ``--trace 1``),
``attempted``, ``failed``, ``memory_peak_bytes`` and ``checks``, the
numbers compared with the limits.  The model of a configuration's family
is found by name too: ``gnnbench/programs/<family>.py`` builds the
program's, ``gnnbench/reference/<family>.py`` holds the plain one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dist_gnn_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: Dict, workload: str) -> Tuple[Dict, Dict]:
    """``(cell, config entry)`` of ``workload``, a cell of ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return cell, {c["name"]: c for c in manifest["configs"]}[cell["config"]]


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("gnnbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace_on: bool, device: torch.device,
             t_start: float, cfg_override: Optional[Dict] = None, traffic_override: Optional[Dict] = None,
             setup_parts: Optional[Dict] = None) -> Dict:
    """The result line of one run of ``workload``.  ``cfg_override``
    replaces the configuration and ``traffic_override`` updates the traffic
    mix, for tests at a small size; ``setup_parts`` (seconds of set-up
    that the line reports apart, such as the kernel build) goes into the
    line as it is."""
    manifest = load_json(root / "BENCHMARK.json")
    cell, conf = find_cell(manifest, workload)
    cfg = cfg_override if cfg_override is not None else load_json(root / conf["file"])
    traffic = dict(load_json(HERE / "traffic" / f"{cell['traffic']}.json"), **(traffic_override or {}))
    limits = load_json(HERE / "limits" / f"{workload}.json")["checks"]
    driver = importlib.import_module(f"gnnbench.drivers.{traffic['driver']}")

    out = driver.run(cfg, traffic, seed, seconds, trace_on, device, t_start)

    metrics = {}
    if trace_on:
        record = out["record"]
        for m in manifest["per_layer"]:
            if applies(m, workload):
                value = reader(m["name"])(record)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in manifest["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}

    checks = out["checks"]
    if set(checks) != set(limits):
        raise RuntimeError(f"the run compared {sorted(checks)}, the limits name {sorted(limits)}")
    # a limit of null: a reading that no control or fault separates from sound runs, reported only
    compared = sorted(k for k in checks if limits[k]["limit"] is not None)
    correct = all(checks[k] <= limits[k]["limit"] for k in compared)
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(out["memory_peak_bytes"]),
    }
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    line: Dict = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
                  "metrics": metrics, "device": dev}
    if trace_on:
        tr = out["record"]["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        line["profiler"] = {"kept_share": tr["kept_share"], "sessions": tr["sessions"],
                            "launches": tr["launches"]}
    if setup_parts is not None:
        line["setup_parts"] = setup_parts
    line["readings"] = {k: checks[k] for k in sorted(checks) if k not in compared}
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]["limit"]} for k in compared}
    return line
