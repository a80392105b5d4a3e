"""The reader of ``walk_heavy_edges_pct.infer`` on spans records built by
hand: a program that counts the walk, and one that does not."""

import json

import pytest

from gnnbench import harness
from gnnbench.tests.small import ROOT

NAME = "walk_heavy_edges_pct.infer"


def _record(counters, kind="infer"):
    return {"passes": 1, "spans": {"kind": kind, "counters": counters}}


def test_it_is_a_counter_of_the_gather_ops_in_the_full_graph_cell():
    (entry,) = [m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"] if m["name"] == NAME]
    assert entry["source"] == "program_counter" and entry["layer"] == "gather ops"
    assert entry["moves"] == "infer_edges_per_s" and entry["workloads"] == ["sage-products.infer-full"]


def test_it_reads_the_heavy_rows_edges_over_the_edges_walked():
    counters = {"infer.walk_edges": 3 * 1000, "infer.walk_heavy_edges": 3 * 217, "infer.walk_heavy_rows": 3 * 4}
    assert harness.reader(NAME)(_record(counters)) == pytest.approx(21.7)
    counters["infer.walk_heavy_edges"] = 0  # no heavy row: the share is 0, not None
    assert harness.reader(NAME)(_record(counters)) == 0.0


@pytest.mark.parametrize(
    "record",
    [_record({}), _record({"sample.frontier_rows": 5, "sample.frontier_alloc": 10}),
     _record({"infer.walk_edges": 10, "infer.walk_heavy_edges": 1}, kind="train"),
     {"passes": 1, "spans": None}, {"passes": 1, "trace": {}}],
    ids=["no_counters", "other_counters", "training_record", "no_spans", "no_measurement"],
)
def test_it_reads_none_where_the_walk_is_not_counted(record):
    """The parent's program records no walk counters: the line leaves the
    metric out."""
    assert harness.reader(NAME)(record) is None
