"""The transformer cell and the GAT full-graph cell: the transformer
reference's model operations by hand, the five readers of the attention on
a recorded fake, and the comparison that decides ``correct`` at a small
size on the CPU (the control fails a limit, the program passes, each
planted fault makes a run not correct)."""

import time

import pytest
import torch

from gnnbench import calibrate, common, harness
from gnnbench.reference import models as ref_models
from gnnbench.rooflines import attn_bwd, attn_fwd, k5_gat_bwd
from gnnbench.tests.small import INFER, ROOT, TRAIN, config

CPU = torch.device("cpu")
CELL = "transformer-products.train-b4096"
READERS = ["attention_ms.train", "gate_norm_ms.train", "attn_slot_fill_pct.train", "attn_fwd_roofline",
           "attn_bwd_roofline"]
MID = dict(nodes=20000, edges=200000, train=4000)


def test_train_flops_by_hand():
    """Layer 0 (100 -> 4 x 128), 10 rows and 30 slots, and the last layer
    (512 -> 4 x 47, width 47), 4 rows and 12 slots, counted by hand."""
    cfg = config("transformer-products")
    cfg["model"]["num_layers"] = 2
    fam = ref_models.family("transformer")
    assert fam.layer_dims(cfg) == [(100, 128), (512, 47)] and fam.widths(cfg) == [512, 47]
    l0 = (2 * 10 * 100 * 512) * 3 + 2 * 30 * 100 * 4 * 2 + 2 * 10 * 100 * 512 + 2 * 10 * 3 * 512
    l1 = (2 * 4 * 512 * 188) * 3 + 2 * 12 * 512 * 4 * 2 + 2 * 4 * 512 * 47 + 2 * 4 * 3 * 47
    assert fam.train_flops(cfg, [10, 4], [30, 12]) == 2 * l0 + 3 * l1


def test_the_family_is_found_by_name_and_has_no_full_pass():
    cfg = config("transformer-products")
    fam = ref_models.family("transformer")
    shapes = fam.param_shapes(cfg)
    assert set(common.make_weights(cfg, 1, CPU)) == set(shapes)
    assert shapes["layer0.w"] == (100, 1536) and shapes["layer2.b"] == (2 * 188 + 47,)
    assert "layer1.ln_s" in shapes and "layer2.ln_s" not in shapes
    with pytest.raises(NotImplementedError):
        fam.full({}, None, None, None, cfg)
    with pytest.raises(NotImplementedError):
        fam.full_flops(cfg, 1, 1)


class _Block:
    def __init__(self, S, k, rows, slots):
        self.neigh_slots = torch.zeros(S, k, dtype=torch.int32)
        self.seed_mask = torch.arange(S) < rows
        self.neigh_mask = (torch.arange(S * k) < slots).reshape(S, k)


def _record(family="transformer"):
    cfg = config("transformer-products")
    blocks = [_Block(200, 5, 180, 900), _Block(40, 10, 36, 350), _Block(8, 15, 8, 110)]
    dims = ref_models.family("transformer").layer_dims(cfg)
    spans = {"kind": "train", "roots": 2, "device_s": {"forward.attention": 0.004, "forward.gate": 0.001},
             "counters": {"attn.slots": 1360, "attn.slot_alloc": 1600}, "paced_host_s": 0.01}
    trace = {"kernels": {"gat_bwd_bf16_kernel": [0.003, 6], "gat_dw_bf16_kernel": [0.001, 6],
                         "attn_score_bwd_kernel": [0.002, 6], "attn_score_fwd_kernel": [0.5, 6]}}
    return {"steps": 2, "family": family, "cfg": cfg, "dims": dims, "heads": 4, "blocks": [blocks, blocks],
            "trace": trace, "spans": spans}, blocks, dims


def test_the_attention_readers_read_a_recorded_fake():
    record, blocks, dims = _record()
    assert harness.reader("attention_ms.train")(record) == pytest.approx(2.0)
    assert harness.reader("gate_norm_ms.train")(record) == pytest.approx(0.5)
    assert harness.reader("attn_slot_fill_pct.train")(record) == pytest.approx(85.0)
    fwd = bwd = 0.0
    for l, b in enumerate(blocks):
        S, k = b.neigh_slots.shape
        E, D = dims[l]
        rows, slots = int(b.seed_mask.sum()), int(b.neigh_mask.sum())
        nb, fl = attn_fwd.layer_cost(S, k, E, 4, D, rows, slots)
        assert nb == slots * E * 2 + S * E * 2 + 3 * E * 4 * D * 2 + S * k * 4 + S * 4 * D * 2
        assert fl == 6 * rows * E * 4 * D + 4 * slots * E * 4
        fwd += max(nb / 3.35e12, fl / 989e12)
        kb, kf = k5_gat_bwd.layer_cost(S, k, E, 4, D, rows, slots, l > 0)
        sb, sf = attn_bwd.score_bwd_cost(S, k, E, 4, slots, l > 0)
        assert sb == slots * E * 2 + 2 * S * 4 * E * 2 + slots * 4 * 4 + S * k * 4 + (4 * slots * E if l else 0)
        bwd += max(kb / 3.35e12, kf / 989e12) + max(sb / 3.35e12, sf / 989e12)
    assert harness.reader("attn_fwd_roofline")(record) == pytest.approx(100 * fwd / 0.002)
    assert harness.reader("attn_bwd_roofline")(record) == pytest.approx(100 * 2 * bwd / 0.006)


@pytest.mark.parametrize("name", READERS)
def test_the_attention_readers_read_nothing_elsewhere(name):
    assert CELL in next(m for m in harness.load_json(ROOT / "BENCHMARK.json")["per_layer"]
                        if m["name"] == name)["workloads"]
    read = harness.reader(name)
    gat, _, _ = _record("gat")
    gat["spans"] = dict(gat["spans"], device_s={}, counters={})
    gat["trace"] = {"kernels": {"gat_fwd_bf16_kernel": [0.01, 6]}}
    for record in (gat, {"steps": 10, "family": "transformer", "blocks": [], "trace": {"kernels": {}},
                         "spans": None}, {"passes": 1, "trace": {}, "spans": None}):
        assert read(record) is None


@pytest.mark.parametrize("workload,conf,traffic", [(CELL, "transformer-products", TRAIN),
                                                   ("gat-products.infer-full", "gat-products", INFER)])
def test_the_control_fails_and_the_program_passes(workload, conf, traffic):
    got = {r["kind"]: r for r in calibrate.readings(
        ROOT, workload, [2**31 + 21], [], CPU, config(conf, **MID),
        dict(traffic, batch_per_rank=512) if "train" in workload else traffic)}
    lim = harness.load_json(ROOT / "gnnbench" / "limits" / f"{workload}.json")["checks"]
    failing = {kind: [k for k in lim if lim[k]["limit"] is not None and got[kind][k] > lim[k]["limit"]]
               for kind in ("program", "control")}
    assert failing["program"] == [] and failing["control"] != []


FAULTS = [(CELL, "transformer-products", TRAIN, f) for f in calibrate.FAULTS["train"] + ["unchanged"]] + [
    ("gat-products.infer-full", "gat-products", INFER, f) for f in calibrate.FAULTS["infer_full"]]


@pytest.mark.parametrize("workload,conf,traffic,fault", FAULTS)
def test_a_planted_fault_makes_the_run_not_correct(workload, conf, traffic, fault):
    with calibrate.planted(fault):
        line = harness.run_cell(ROOT, workload, 2**31 + 33, 0.5, False, CPU, time.perf_counter(),
                                cfg_override=config(conf), traffic_override=traffic)
    assert line["correct"] is False, line["checks"]
