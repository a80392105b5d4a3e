"""Scale smoke on one card: the train step's time should not depend on the
graph's size.

Counterpart of the JAX package's ``scripts/bench_scale.py``.  Mini-batch
GraphSAGE's step is sized by the sampled frontier, not by |V| or |E|: the
bench config (SAGE, 3 layers, hidden 256, bf16, fanout (15, 10, 5), batch
512, a dedup-free last hop) runs here on a larger power-law graph, by
default 10M nodes at average degree 15 (about 300M symmetrized edges,
features 100 wide in bf16), all on the card.  The frontier caps come from
``cache.autotune.tune_sampler_for`` (the JAX script's ``tune_sampler_cost``
prices TPU layouts).  Graph size enters only through device residency and
the tuner's simulation.

Usage:  python -m dist_gnn_tpu_torch.scripts.bench_scale [num_nodes[,num_nodes...]] [avg_degree]

Several comma-separated sizes run one after another in this process, so
their steps are one measurement taken at each size.  Prints one JSON line
for each size: ``scale_nodes``, ``scale_edges``, ``step_ms`` (by
the slope of ``measure_chain`` over chains of ``train_step_multi`` calls
of 8 steps), ``edges_per_step``, ``edges_per_s``, the set-up seconds, the
host's memory, and the card's name and power limit.  Compare ``step_ms``
at 10M with the same run at 500k (``500000,10000000``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Dict

import torch

FAN_OUT = (15, 10, 5)
BATCH = 512
HIDDEN = 256
FEATURE_DIM = 100
NUM_CLASSES = 47
UNROLL = 8  # steps per train_step_multi call


def _host_mem_gib() -> Dict[str, Any]:
    """The host's total and available memory, from ``/proc/meminfo``."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                if k in ("MemTotal", "MemAvailable"):
                    out[k] = int(v.split()[0]) / 2**20
    except OSError:
        return {"host_mem_total_gib": None, "host_mem_available_gib": None}
    return {"host_mem_total_gib": out.get("MemTotal"), "host_mem_available_gib": out.get("MemAvailable")}


def _card(dev: torch.device) -> Dict[str, Any]:
    """The card's name and power limit as nvidia-smi gives them (None on
    the CPU)."""
    if dev.type != "cuda":
        return {"card": None, "power": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return {"card": torch.cuda.get_device_name(dev), "power": smi[dev.index or 0]}


def run(num_nodes: int = 10_000_000, avg_degree: int = 15, device=None) -> Dict[str, Any]:
    """Build the graph, train the bench config on it and return the JSON
    line's fields.  ``device`` defaults to the card and raises without
    one."""
    from dist_gnn_tpu_torch.cache.autotune import tune_sampler_for
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models import SAGE
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.training import Trainer
    from dist_gnn_tpu_torch.utils.device import resolve_device
    from dist_gnn_tpu_torch.utils.timing import device_sync, measure_chain

    dev = resolve_device(device)
    mem_before = _host_mem_gib()
    t0 = time.perf_counter()
    arrays, meta = make_synthetic_dataset(num_nodes=num_nodes, avg_degree=avg_degree, feature_dim=FEATURE_DIM,
                                          num_classes=NUM_CLASSES, train_frac=0.05, seed=0)
    synth_s = time.perf_counter() - t0
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])

    t0 = time.perf_counter()
    cfg = tune_sampler_for(hg, arrays["train_idx"], BATCH, FAN_OUT)
    tune_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    graph = hg.to_device(dev)
    features = torch.from_numpy(arrays["features"]).to(dev, torch.bfloat16)
    labels = torch.from_numpy(arrays["labels"]).to(dev)
    device_sync(features)
    upload_s = time.perf_counter() - t0
    del arrays["features"]

    model = SAGE(FEATURE_DIM, HIDDEN, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(model=model, fan_out=FAN_OUT, dedup_last=False, frontier_caps=cfg.frontier_caps, device=dev)

    gen = SeedGenerator(arrays["train_idx"], BATCH, shuffle=True, drop_last=True, device=dev)
    batches, ep = [], 0
    while len(batches) < UNROLL:  # small graphs: cycle epochs to fill the unroll
        for b in gen.epoch(torch.Generator().manual_seed(100 + ep)):
            batches.append(b)
            if len(batches) == UNROLL:
                break
        ep += 1
    sU = torch.stack([b[0] for b in batches])
    mU = torch.stack([b[1] for b in batches])
    key = torch.Generator(device=dev).manual_seed(7)

    def one_call(carry):
        return trainer.train_step_multi(graph, features, labels, sU, mU, key)["loss"]

    dt_step = measure_chain(one_call, None, n_lo=4, n_hi=16, reps=3) / UNROLL

    blocks, stats = sample_blocks(graph, batches[0][0], batches[0][1], FAN_OUT, False,
                                  torch.Generator(device=dev).manual_seed(7), frontier_caps=cfg.frontier_caps,
                                  dedup_last=False)
    if int(stats["sampler_overflow"]) or int(stats["frontier_overflow"]):
        raise RuntimeError(f"the tuned caps overflowed at this scale: {({k: int(v) for k, v in stats.items()})}")
    edges_per_step = int(sum(int(b.neigh_mask.sum()) for b in blocks))
    return {
        "metric": "scale_smoke_train_edges_per_s",
        "scale_nodes": num_nodes,
        "scale_edges": int(meta["num_edges"]),
        "step_ms": dt_step * 1e3,
        "edges_per_step": edges_per_step,
        "edges_per_s": edges_per_step / dt_step,
        "frontier_caps": list(cfg.frontier_caps),
        "synth_s": synth_s, "tune_s": tune_s, "upload_s": upload_s,
        "device": str(dev),
        "device_mem_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
        **{f"{k}_before": v for k, v in mem_before.items()},
        **_host_mem_gib(),
        **_card(dev),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    sizes = [int(n) for n in argv[0].split(",")] if len(argv) > 0 else [10_000_000]
    avg_degree = int(argv[1]) if len(argv) > 1 else 15
    for num_nodes in sizes:
        print(json.dumps(run(num_nodes, avg_degree)), flush=True)


if __name__ == "__main__":
    main()
