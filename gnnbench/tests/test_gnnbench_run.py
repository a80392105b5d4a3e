"""A whole run of each cell at a tiny size on the CPU (the look for a card
skipped), the result line's keys, the trace reduction, and the check that
no module of JAX or of the JAX package is loaded."""

import subprocess
import sys
import time

import pytest
import torch

from gnnbench import harness, trace
from gnnbench.tests.small import INFER, ROOT, TRAIN, config

CELLS = [("sage-products.train-b4096", "sage-products", TRAIN), ("gat-products.train-b4096", "gat-products", TRAIN),
         ("sage-products.infer-full", "sage-products", INFER)]


@pytest.mark.parametrize("workload,conf,traffic", CELLS)
def test_a_run_prints_the_contracts_keys(workload, conf, traffic):
    line = harness.run_cell(ROOT, workload, 2**31 + 77, 1.0, False, torch.device("cpu"), time.perf_counter(),
                            cfg_override=config(conf), traffic_override=traffic)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "readings", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in manifest["end_to_end"] if harness.applies(m, workload)}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    limits = harness.load_json(ROOT / "gnnbench" / "limits" / f"{workload}.json")["checks"]
    assert set(line["checks"]) | set(line["readings"]) == set(limits)
    assert set(line["checks"]) == {k for k, v in limits.items() if v["limit"] is not None}


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::add_kernel<float>(int)", "ts": 10.0, "dur": 20.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 40.0, "dur": 1.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::gather_rows_kernel<2>(int*)", "ts": 60.0,
         "dur": 30.0, "args": {"correlation": 2}},
    ]
    r = trace.reduce_trace(ev)
    assert r["window_s"] == pytest.approx(100e-6) and r["busy_s"] == pytest.approx(50e-6)
    assert r["launches"] == 2 and r["kernel_records"] == 2
    assert r["kernels"]["gather_rows_kernel"] == [pytest.approx(30e-6), 1]
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::add -> at::native::add_kernel"] == pytest.approx(10e-6)
    assert gaps["python (no aten op) -> gather_rows_kernel"] == pytest.approx(30e-6)
    assert gaps["window end (host finishing)"] == pytest.approx(10e-6)
    assert trace.kernel_seconds(r, "gather_rows") == pytest.approx(30e-6)


def test_trace_window_without_host_ops():
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 20.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 12.0, "dur": 28.0},
    ]
    r = trace.reduce_trace(ev)
    assert r["window_s"] == pytest.approx(35e-6) and r["busy_s"] == pytest.approx(20e-6) and r["launches"] == 1


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dist_gnn_tpu_torch_fake", sys)
    assert "dist_gnn_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
from gnnbench import harness, calibrate
from gnnbench.tests.small import config, TRAIN, INFER
for w, c, t in [("sage-products.train-b4096", "sage-products", TRAIN), ("sage-products.infer-full", "sage-products", INFER)]:
    harness.run_cell(harness.HERE.parent, w, 3, 0.5, False, torch.device("cpu"), time.perf_counter(), config(c), t)
for m in harness.load_json(harness.HERE.parent / "BENCHMARK.json")["per_layer"]:
    harness.reader(m["name"])
print("FOUND", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import gnnbench.reference.models, gnnbench.reference.sampler, gnnbench.reference.prng
import gnnbench.reference.sage, gnnbench.reference.gat
import gnnbench.rooflines.k6_sample
print(sorted(m for m in sys.modules if m.split(".")[0] in ("dist_gnn_tpu_torch", "dist_gnn_tpu", "jax")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_without_a_card_the_run_fails_and_prints_nothing(card_absent):
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload", "sage-products.train-b4096",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
