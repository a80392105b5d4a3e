"""The port's span recorder (``dist_gnn_tpu_torch/utils/trace.py``) and the
spans the training step, the sampler, dropout and the full-graph pass
open, on the CPU."""

import threading

import numpy as np
import pytest
import torch

from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
from dist_gnn_tpu_torch.graph import HostGraph
from dist_gnn_tpu_torch.models import GAT, SAGE
from dist_gnn_tpu_torch.models.inference import full_graph_inference
from dist_gnn_tpu_torch.training import Trainer
from dist_gnn_tpu_torch.utils import trace

PHASES = ["sample", "gather", "gather", "forward", "backward", "optimizer"]


@pytest.fixture
def tracing():
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


@pytest.fixture(scope="module")
def data():
    arrays, meta = make_synthetic_dataset(num_nodes=400, avg_degree=5, feature_dim=12, num_classes=6,
                                          train_frac=0.3, seed=1)
    return arrays, meta, HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])


# ---- the recorder ------------------------------------------------------------------


def test_spans_nest_with_parents_roots_and_threads():
    rec = trace.Recorder()
    rec.on = True
    with rec.span("step"):
        with rec.span("a", hop=0):
            with rec.span("a.inner"):
                pass
        with rec.span("b"):
            pass
    with rec.span("step"):
        pass

    def other():
        with rec.span("worker"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    spans, counters, dropped = rec.drain()
    by = {s["name"]: s for s in spans if s["name"] != "step"}
    steps = [s for s in spans if s["name"] == "step"]
    assert [s["name"] for s in spans] == ["a.inner", "a", "b", "step", "step", "worker"]
    assert by["a"]["attrs"] == {"hop": 0} and by["a.inner"]["parent"] == by["a"]["id"]
    assert by["a"]["parent"] == by["b"]["parent"] == steps[0]["id"] and steps[0]["parent"] is None
    assert {by["a"]["root"], by["a.inner"]["root"], by["b"]["root"]} == {steps[0]["id"]}
    assert steps[1]["root"] == steps[1]["id"] != steps[0]["id"]
    assert by["worker"]["parent"] is None and by["worker"]["tid"] != steps[0]["tid"]
    assert by["worker"]["tid"] == t.native_id and steps[0]["tid"] == threading.get_native_id()
    for s in spans:
        assert 0 < s["t0"] <= s["t1"]
    assert by["a"]["t0"] <= by["a.inner"]["t0"] <= by["a.inner"]["t1"] <= by["a"]["t1"] <= by["b"]["t0"]
    assert counters == {} and dropped == 0


def test_the_cap_drops_and_counts_and_drain_clears():
    rec = trace.Recorder(cap=3)
    rec.on = True
    for i in range(5):
        with rec.span("s", i=i):
            pass
    spans, _, dropped = rec.drain()
    assert [s["attrs"]["i"] for s in spans] == [0, 1, 2] and dropped == 2
    assert rec.drain() == ([], {}, 0)


def test_counters_sum_ints_and_0d_tensors_at_drain():
    rec = trace.Recorder()
    rec.on = True
    a = torch.tensor(3, dtype=torch.int32)
    rec.count("rows", a)
    rec.count("rows", torch.tensor(4, dtype=torch.int64))
    rec.count("rows", 5)
    rec.count("alloc", 10)
    a.add_(1)  # kept by reference: summed as it stands at drain
    _, counters, _ = rec.drain()
    assert counters == {"rows": 13, "alloc": 10}
    assert rec.drain()[1] == {}


def test_the_cap_bounds_the_counters_tensors():
    rec = trace.Recorder(cap=2)
    rec.on = True
    for i in range(4):
        rec.count("rows", torch.tensor(i + 1))
        rec.count("alloc", 10)  # ints go to a running sum: nothing kept, nothing dropped
    assert rec.refs == 2 and rec.counters["alloc"] == [40, []]
    _, counters, dropped = rec.drain()
    assert counters == {"rows": 1 + 2, "alloc": 40} and dropped == 2
    rec.count("rows", torch.tensor(7))  # the drain freed the room
    assert rec.drain() == ([], {"rows": 7}, 0)


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not trace.enabled()
    trace.drain()
    s1, s2 = trace.span("x"), trace.span("y", hop=1)
    assert s1 is s2 is trace.NOOP
    with s1 as got:
        assert got is trace.NOOP
    trace.count("c", torch.tensor(1))
    assert trace.drain() == ([], {}, 0)
    rec = trace.Recorder()
    assert rec.span("x") is trace.NOOP


def test_summary_is_the_mean_after_the_warmup():
    spans = [{"name": "s", "t0": 10 * i, "t1": 10 * i + d} for i, d in enumerate((5_000_000, 2_000_000, 4_000_000))]
    assert trace.summary(warmup=1, spans=spans) == {"s": pytest.approx(3.0)}
    assert trace.summary(warmup=5, spans=spans) == {"s": pytest.approx(4.0)}


# ---- the program's spans --------------------------------------------------------------


def _step_inputs(data, batch=24):
    arrays, meta, hg = data
    feats, labels = torch.from_numpy(arrays["features"]), torch.from_numpy(arrays["labels"])
    seeds = torch.from_numpy(arrays["train_idx"][:batch].astype(np.int32))
    mask = torch.ones(batch, dtype=torch.bool)
    mask[-3:] = False
    return hg.to_device("cpu"), feats, labels, seeds, mask, meta


def _train(data, steps=2, caps=None):
    g, feats, labels, seeds, mask, meta = _step_inputs(data)
    model = SAGE(12, 16, meta["num_classes"], 3, generator=torch.Generator().manual_seed(4), device="cpu")
    tr = Trainer(model=model, fan_out=(4, 3, 2), dedup_last=False, device="cpu", frontier_caps=caps)
    gen = torch.Generator().manual_seed(9)
    got = []
    kept = []
    hook = model.register_forward_pre_hook(lambda m, a: kept.append([b._asdict() for b in a[0]]))
    for _ in range(steps):
        got.append(tr.train_step(g, feats, labels, seeds, mask, gen))
    hook.remove()
    return got, {k: v.detach().clone() for k, v in model.state_dict().items()}, kept


def test_train_step_spans_form_the_phase_tree(data, tracing):
    _train(data, steps=2, caps=(60, 150, 10**6))
    spans, counters, dropped = trace.drain()
    assert dropped == 0
    roots = sorted((s for s in spans if s["name"] == "train_step"), key=lambda s: s["t0"])
    assert len(roots) == 2
    for root in roots:
        mine = [s for s in spans if s["root"] == root["id"] and s is not root]
        top = sorted((s for s in mine if s["parent"] == root["id"]), key=lambda s: s["t0"])
        assert [s["name"] for s in top] == PHASES
        for a, b in zip(top, top[1:]):  # in order, none overlapping
            assert root["t0"] <= a["t0"] <= a["t1"] <= b["t0"] <= b["t1"] <= root["t1"]
        sample = top[0]
        hops = sorted((s for s in mine if s["parent"] == sample["id"]), key=lambda s: s["t0"])
        assert [(s["name"], s["attrs"]["hop"]) for s in hops] == [
            (n, h) for h in range(3) for n in ("sample.draw", "sample.relabel")]
        drops = [s for s in mine if s["name"] == "forward.dropout"]
        assert len(drops) == 2 and all(s["parent"] == top[3]["id"] for s in drops)
        assert {s["tid"] for s in mine} == {root["tid"]}
    # frontiers: hop 0 of 24 seeds (cap 60), hop 1 capped at 150, the dedup-free last hop 150 * (1 + 4)
    assert counters["sample.frontier_alloc"] == 2 * (60 + 150 + 150 * 5)
    assert 0 < counters["sample.frontier_rows"] <= counters["sample.frontier_alloc"]


def test_frontier_rows_count_the_valid_slots(data, tracing):
    _, _, kept = _train(data, steps=2)
    _, counters, _ = trace.drain()
    want = sum(int(b["frontier_mask"].sum()) for blocks in kept for b in blocks)
    alloc = sum(b["frontier_mask"].numel() for blocks in kept for b in blocks)
    # each hidden layer's dropout masks its [S, 16] output once
    drops = sum(b["seeds"].shape[0] * 16 for blocks in kept for b in blocks[:-1])
    assert counters == {"sample.frontier_rows": want, "sample.frontier_alloc": alloc, "dropout.elems": drops}


def test_tracing_changes_nothing_the_step_computes(data):
    trace.drain()
    off = _train(data, steps=3, caps=(60, 150, 10**6))
    trace.enable()
    try:
        on = _train(data, steps=3, caps=(60, 150, 10**6))
    finally:
        trace.disable()
        trace.drain()
    for a, b in zip(off[0], on[0]):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    for sa, sb in zip(off[2], on[2]):
        for ba, bb in zip(sa, sb):
            assert all(torch.equal(ba[f], bb[f]) for f in ba)


@pytest.mark.parametrize("family", ["sage", "gat"])
def test_full_graph_inference_spans(data, tracing, family):
    arrays, meta, hg = data
    L = 3
    if family == "sage":
        model = SAGE(12, 16, meta["num_classes"], L, generator=torch.Generator().manual_seed(1), device="cpu")
    else:
        model = GAT(12, 8, meta["num_classes"], L, num_heads=2, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    out = full_graph_inference(model, None, hg, torch.from_numpy(arrays["features"]), edge_chunk=256, device="cpu")
    spans, _, _ = trace.drain()
    (root,) = [s for s in spans if s["name"] == "infer_pass"]
    assert all(s["root"] == root["id"] for s in spans)
    children = sorted((s for s in spans if s["parent"] == root["id"]), key=lambda s: s["t0"])
    names = [s["name"] for s in children]
    per_layer = ["infer.edge_walk", "infer.dense"] if family == "sage" else ["infer.dense", "infer.edge_walk", "infer.dense"]
    assert names == ["infer.upload"] + per_layer * L
    assert [s["attrs"]["layer"] for s in children[1:]] == [l for l in range(L) for _ in per_layer]
    trace.disable()
    assert torch.equal(out, full_graph_inference(model, None, hg, torch.from_numpy(arrays["features"]),
                                                 edge_chunk=256, device="cpu"))


@pytest.mark.parametrize("family", ["sage", "gcn", "gat"])
def test_full_graph_inference_counts_the_walk(tracing, family):
    """SAGE and GCN count, per layer, the edges K3-csr walks and the heavy
    rows' rows and edges (the plan's 0-d tensors); GAT walks no CSR."""
    from dist_gnn_tpu_torch.models import GCN
    from dist_gnn_tpu_torch.ops import gather

    rng = np.random.default_rng(2)
    n, hub = 300, gather.CSR_LIGHT_MAX + 30  # node 7 takes a hub's in-edges
    dst = np.concatenate([rng.integers(0, n, 900), np.full(hub, 7)])
    hg = HostGraph.from_coo(rng.integers(0, n, dst.shape[0]), dst, n)
    feats = torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
    L, gen = 2, torch.Generator().manual_seed(1)
    if family == "sage":
        model = SAGE(12, 16, 5, L, generator=gen, device="cpu")
    elif family == "gcn":
        model = GCN(12, 16, 5, L, generator=gen, device="cpu")
    else:
        model = GAT(12, 8, 5, L, num_heads=2, generator=gen, device="cpu")
    full_graph_inference(model, None, hg, feats, edge_chunk=128, device="cpu")
    _, counters, dropped = trace.drain()
    deg = np.diff(hg.indptr)
    if family == "gat":
        assert not any(name.startswith("infer.walk") for name in counters)
        return
    assert dropped == 0 and deg[7] > gather.CSR_LIGHT_MAX
    assert counters == {"infer.walk_edges": L * hg.num_edges,
                        "infer.walk_heavy_rows": L * int((deg > gather.CSR_LIGHT_MAX).sum()),
                        "infer.walk_heavy_edges": L * int(deg[deg > gather.CSR_LIGHT_MAX].sum())}
