"""The comparison that decides ``correct`` fails what it must: the control
(the plain reference in float8 put in the program's place) fails one of a
cell's limits, and a whole run with a fault planted underneath the timed
path comes out not correct.  At a small size on the CPU; the readings at
the cells' own sizes on the card are in PERF.md."""

import time

import pytest
import torch

from gnnbench import calibrate, harness
from gnnbench.tests.small import INFER, ROOT, TRAIN, config

CPU = torch.device("cpu")
CELLS = {"sage-products.train-b4096": ("sage-products", TRAIN),
         "gat-products.train-b4096": ("gat-products", TRAIN),
         "sage-products.infer-full": ("sage-products", INFER)}
MID = dict(nodes=20000, edges=200000, train=4000)


def limits(workload):
    return harness.load_json(ROOT / "gnnbench" / "limits" / f"{workload}.json")["checks"]


def failing(reading, lim):
    return [k for k in lim if lim[k]["limit"] is not None and reading[k] > lim[k]["limit"]]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_fails_and_the_program_passes(workload):
    conf, traffic = CELLS[workload]
    got = {r["kind"]: r for r in calibrate.readings(ROOT, workload, [2**31 + 21], [], CPU, config(conf, **MID),
                                                    dict(traffic, batch_per_rank=512) if "train" in workload
                                                    else traffic)}
    lim = limits(workload)
    assert failing(got["program"], lim) == []
    assert failing(got["control"], lim) != []


FAULTS = [(w, f) for w in sorted(CELLS) for f in calibrate.FAULTS[
    "infer_full" if "infer" in w else "train"] + (["unchanged"] if "train" in w else [])]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_makes_the_run_not_correct(workload, fault):
    conf, traffic = CELLS[workload]
    with calibrate.planted(fault):
        line = harness.run_cell(ROOT, workload, 2**31 + 33, 0.5, False, CPU, time.perf_counter(),
                                cfg_override=config(conf), traffic_override=traffic)
    assert line["correct"] is False, line["checks"]
