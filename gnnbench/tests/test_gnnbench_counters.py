"""The byte and operation counters against shapes worked out by hand."""

import pytest
import torch

from gnnbench.reference.sampler import INVALID
from gnnbench.reference import gat, sage
from gnnbench.rooflines import k1_gather, k3_bwd, k4_gat_fwd, k5_gat_bwd, k6_sample


def test_k1_counts_distinct_rows_once():
    idx = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    assert k1_gather.call_bytes(idx, 200) == 3 * 200 + 4 * (4 + 200)


def test_k3_bwd_layer():
    slots = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.tensor([[True, True, False], [True, True, False]])
    # transpose 2*3*5 + 11*4 + 4*8 + 2*4; backward 2*8*2 + 2*3*5 + 10*8*2
    assert k3_bwd.layer_bytes(slots, mask, cap=10, width=8) == 114 + 222


def test_k4_and_k5_layers():
    assert k4_gat_fwd.layer_cost(2, 3, 4, 2, 5, valid_rows=2, valid_slots=4) == (224, 224)
    assert k5_gat_bwd.layer_cost(2, 3, 4, 2, 5, 2, 4, need_dx=True) == (464, 512)
    assert k5_gat_bwd.layer_cost(2, 3, 4, 2, 5, 2, 4, need_dx=False) == (432, 448)


def test_k6_short_rows_read_their_sectors():
    indices = torch.arange(64, dtype=torch.int32)  # 8 sectors
    indptr = torch.tensor([0, 2, 10, 64], dtype=torch.int32)
    seeds = torch.tensor([0, 1, INVALID], dtype=torch.int32)
    key = torch.tensor([7, 8, 9], dtype=torch.int64)
    assert indices.data_ptr() % 32 == 0 and indptr.data_ptr() % 32 == 0
    # rows of degree <= k take their first slots: positions 0-1 and 2-9,
    # bytes 0-39 of indices (2 sectors); indptr entries 0-2 (1 sector)
    assert k6_sample.hop_bytes(indptr, indices, seeds, 8, key) == 3 * 32 + 3 * 4 + 3 * 8 + 3 * 8 * 5


def cfg(layers, feature_dim, hidden, classes, heads=1):
    return {"model": {"num_layers": layers, "hidden": hidden, "heads": heads},
            "graph": {"feature_dim": feature_dim, "num_classes": classes}}


def test_step_flops():
    # dims (2, 3), (3, 4)
    assert sage.train_flops(cfg(2, 2, 3, 4), rows=[5, 2], slots=[7, 3]) == 254 + 306
    # dims (2, 3), 2 heads
    assert gat.train_flops(cfg(1, 2, 7, 3, heads=2), rows=[5], slots=[7]) == 544
    assert sage.full_flops(cfg(1, 2, 7, 3), num_nodes=10, num_edges=20) == 280
    # projection 2*10*2*6, scores 2*2*10*6, sums 2*20*6
    assert gat.full_flops(cfg(1, 2, 7, 3, heads=2), num_nodes=10, num_edges=20) == 240 + 240 + 240


def test_step_p95_reads_the_steady_gaps():
    from gnnbench import harness

    read = harness.reader("step_ms_p95.train")
    assert read({"steady_step_ms": [float(v) for v in range(1, 21)]}) == pytest.approx(19.05)
    assert read({"passes": 1}) is None
