"""The reduction of a profiled session by the program's spans, on a trace
built by hand, and the readers of the span metrics."""

import subprocess

import pytest
import torch

from gnnbench import harness, spans
from gnnbench.tests.small import ROOT, TRAIN, config

CPU = torch.device("cpu")

US = 1000  # ns


def _span(sid, name, parent, root, t0_us, t1_us, tid=1, **attrs):
    return {"name": name, "attrs": attrs, "id": sid, "parent": parent, "root": root, "tid": tid, "ident": 100 + tid,
            "t0": t0_us * US, "t1": t1_us * US}


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# host clock + 500 us = the trace's clock
ANCHORS = ((1000 * US, 1010 * US), (2000 * US, 2100 * US))
SPANS = [
    _span(1, "sample.relabel", 2, 0, 1200, 1290, hop=0),
    _span(2, "sample", 0, 0, 1150, 1300),
    _span(3, "backward", 0, 0, 1400, 1700),
    _span(0, "train_step", None, 0, 1100, 1900),
]


def _events(second_sync_ts=2500.0):
    return [
        _x("cuda_runtime", "cudaDeviceSynchronize", 1500.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1660.0, 2.0, corr=1),  # in sample
        _x("kernel", "void ka<int>(int)", 1700.0, 20.0, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1710.0, 2.0, corr=2),  # in sample.relabel
        _x("kernel", "kb", 1750.0, 30.0, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1950.0, 2.0, corr=3, tid=2),  # autograd's thread: no span
        _x("kernel", "kc", 2000.0, 100.0, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 2450.0, 2.0, corr=4),  # after the root: the feed
        _x("gpu_memcpy", "Memcpy HtoD", 2460.0, 10.0, corr=4),
        _x("cuda_runtime", "cudaDeviceSynchronize", second_sync_ts, 100.0),
        _x("cuda_runtime", "cudaDeviceSynchronize", 2600.0, 5.0),  # the profiler's own, when it stops
    ]


def test_device_time_by_span_on_the_anchors_line():
    r = spans.reduce_session(_events(), SPANS, ANCHORS, "train_step")
    assert r["roots"] == 1 and r["anchor_us"] == pytest.approx(0.0, abs=1e-6)
    d = r["device_s"]
    assert d["train_step"] == pytest.approx(150e-6)
    assert d["sample"] == pytest.approx(50e-6) and d["sample.relabel"] == pytest.approx(30e-6)
    assert d["backward"] == pytest.approx(100e-6)  # launched on a thread with no span open: the root's thread
    assert r["outside_s"] == pytest.approx(10e-6) and r["session_s"] == pytest.approx(160e-6)
    assert r["launches"] == 3 and r["kernel_records"] == 3


def test_anchors_that_disagree_read_nothing():
    r = spans.reduce_session(_events(second_sync_ts=2560.0), SPANS, ANCHORS, "train_step")
    assert r["anchor_us"] == pytest.approx(60.0)
    assert r["device_s"] is None and r["outside_s"] is None
    ok = spans.reduce_session(_events(second_sync_ts=2540.0), SPANS, ANCHORS, "train_step")
    assert ok["anchor_us"] == pytest.approx(40.0) and ok["device_s"] is not None
    assert spans.reduce_session(_events()[1:-2], SPANS, ANCHORS, "train_step")["device_s"] is None


def test_each_end_takes_the_median_of_its_anchors():
    # three anchors before the work and three after; the trace's clock is the host's + 500 us
    anchors = [(1000 * US, 1010 * US), (1020 * US, 1030 * US), (1040 * US, 1050 * US),
               (2000 * US, 2010 * US), (2020 * US, 2030 * US), (2040 * US, 2050 * US)]
    offsets = [500.0, 515.0, 502.0, 505.0, 499.0, 507.0]  # one wild anchor before the work
    events = [_x("cuda_runtime", "cudaDeviceSynchronize", a[0] / US + o, 10.0) for a, o in zip(anchors, offsets)]
    events.append(_x("cuda_runtime", "cudaDeviceSynchronize", 52600.0, 5.0))  # the profiler's own, 50 ms on
    to_trace, disagree, spread = spans._anchor_line(events, anchors)
    assert disagree == pytest.approx(3.0) and spread == pytest.approx(15.0)
    assert to_trace(1025 * US) == pytest.approx(1527.0)


def test_a_trace_names_a_thread_by_its_pthread_ids_low_32_bits():
    below = {"tid": 232, "ident": 0x7F7A7AC73300}  # low 32 bits 2059875072 < 2**31: as they are
    above = {"tid": 122, "ident": 0x7F35C5B24300}  # 3316794112 >= 2**31: the trace gives 2**32 less it
    assert {232, 0x7F7A7AC73300, 2059875072} == spans._thread_keys(below)
    assert 978173184 in spans._thread_keys(above) and 122 in spans._thread_keys(above)


NEW = ["host_issue_pct.train", "sample_ms.train", "relabel_ms.train", "frontier_fill_pct.train", "forward_ms.train",
       "dropout_ms.train", "backward_ms.train", "optimizer_ms.train", "host_issue_pct.infer", "upload_ms.infer",
       "edge_walk_ms.infer", "draw_ms.train", "gather_ms.train", "dense_ms.infer"]


@pytest.mark.parametrize("name", NEW)
def test_the_readers_read_nothing_without_spans(name):
    assert name in {m["name"] for m in harness.load_json(ROOT / "BENCHMARK.json")["per_layer"]}
    read = harness.reader(name)
    for record in ({"steps": 10, "trace": {}}, {"passes": 1, "trace": {}}, {"steps": 10, "spans": None}):
        assert read(record) is None


def test_the_readers_read_a_measured_record():
    red = spans.reduce_session(_events(), SPANS, ANCHORS, "train_step")
    red.update(kind="train", root="train_step", paced_host_s=0.006,
               counters={"sample.frontier_rows": 75, "sample.frontier_alloc": 100})
    record = {"steps": 1, "steady_step_s": 0.012, "spans": red}
    assert harness.reader("sample_ms.train")(record) == pytest.approx(0.05)
    assert harness.reader("relabel_ms.train")(record) == pytest.approx(0.03)
    assert harness.reader("backward_ms.train")(record) == pytest.approx(0.1)
    assert harness.reader("optimizer_ms.train")(record) is None  # no launch inside it
    assert harness.reader("host_issue_pct.train")(record) == pytest.approx(50.0)
    assert harness.reader("frontier_fill_pct.train")(record) == pytest.approx(75.0)
    assert harness.reader("upload_ms.infer")(record) is None  # a training record


def test_a_failed_measurement_fails_the_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(spans, "has_recorder", lambda: True)
    record = {"cfg": {}, "passes": 1}
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(a, 1, stdout=""))
    with pytest.raises(RuntimeError, match="exit 1"):
        spans.of(dict(record))

    def late(*a, **k):
        raise subprocess.TimeoutExpired(a, spans.TIMEOUT_S)

    monkeypatch.setattr(subprocess, "run", late)
    with pytest.raises(RuntimeError, match="passed"):
        spans.of(dict(record))
    assert spans.of({"cfg": {}}) is None  # a record of neither driver: nothing to measure


@pytest.mark.parametrize("conf", ["sage-products", "gat-products"])
def test_the_cell_is_built_again_from_a_traced_training_record(conf):
    from dist_gnn_tpu_torch.utils import trace as ptrace
    from gnnbench.drivers.train import TrainCell

    cfg = config(conf)
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "train-b4096.json"), **TRAIN)
    cell = TrainCell(cfg, traffic, 5, CPU)
    cell.build_program()
    got = []
    cell._sink = lambda b, x: got.append(list(b))
    cell.step()
    cell._sink = None
    job = spans.job_of({"cfg": cfg, "fanout": cell.fanout, "blocks": got, "steps": 2, "steady_step_s": 0.01})
    assert job["kind"] == "train" and job["n"] == 2 and job["hops"] == list(cell.hops)
    assert job["traffic"] == {k: traffic[k] for k in ("fanout", "batch_per_rank", "replace", "dedup_last")}
    step, warm = spans.cell_of(job, CPU)
    ptrace.drain()
    ptrace.enable()
    try:
        step()
    finally:
        ptrace.disable()
    sp, counters, dropped = ptrace.drain()
    assert warm == 3 and [s["name"] for s in sp if s["parent"] is None] == ["train_step"] and dropped == 0
    assert counters["sample.frontier_alloc"] == sum(b.frontier.shape[0] for b in got[0])
    with pytest.raises(RuntimeError, match="hop sizes"):
        spans.cell_of(dict(job, hops=[h + 1 for h in job["hops"]]), CPU)


def test_the_cell_is_built_again_from_a_traced_inference_record():
    from dist_gnn_tpu_torch.utils import trace as ptrace

    cfg = config("sage-products")
    job = spans.job_of({"cfg": cfg, "passes": 1, "steady_pass_s": 1.0})
    assert job == {"kind": "infer", "cfg": cfg, "traffic": {"sample_rows": 1}, "n": 1}
    step, warm = spans.cell_of(job, CPU)
    ptrace.drain()
    ptrace.enable()
    try:
        out = step()
    finally:
        ptrace.disable()
    sp, _, _ = ptrace.drain()
    assert warm == 1 and out.shape[0] == cfg["graph"]["num_nodes"]
    assert [s["name"] for s in sp if s["parent"] is None] == ["infer_pass"]
