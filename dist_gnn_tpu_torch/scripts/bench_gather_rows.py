"""K1 (``gather_rows``) beside K2 (``gather_rows_dma``) and
``torch.index_select`` on the card, at the main path's shape and the
gather bench's, in bf16 and f32; then K1 against K2 inside SAGE training
steps.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_gather_rows

Main path: the frontier of ``chip_smoke.py``'s serving request (the
500k-node ``make_synthetic_dataset(seed=0)`` graph, 512 validation seeds,
fanout (15, 10, 5), dedup-free last hop, hop keys from ``Generator(1)``):
L = 540,672 ids into the [500,000, 100] feature table.  Bench: N 500,000,
F 128, L 540,672 uniform ids from ``Generator(7)`` on the card
(``scripts/bench_gather2.py``'s shape).

:func:`measure` times one shape and dtype: ``ms``, CUDA events around 20
back-to-back calls, in the order K1, K2, index_select, index_select, K2,
K1 (each entry the mean of its two turns); ``device_ms``, the time of
every kernel a call launches (one each), from the profiler; ``bound_ms``,
the distinct rows read once, the ids and the output written once, over
3.35 TB/s.  Every output is checked equal to ``table[idx]``.
``chip_smoke.py`` takes its K1 and K2 times from it.

:func:`in_step` runs the feature gather of SAGE training steps through K1
and through K2 in turns; ``main`` runs it over 8 batches in bf16 and f32,
which decides the trainer's gather (``training/trainer.py``).

The script reads only functions that every tree of the port has, so it
also runs against an older one: ``PYTHONPATH=<that tree> python3 <this
file>``.
"""

from __future__ import annotations

import itertools
import json
import subprocess
from typing import Dict, Sequence

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
BENCH_N, BENCH_F, BENCH_L = 500_000, 128, 540_672
FAN_OUT = (15, 10, 5)
BATCH = 512


def measure(table: torch.Tensor, idx: torch.Tensor) -> Dict:
    """K1, K2 (rows_per_step 128) and ``index_select`` on one table and
    id list on the card: each checked equal to ``table[idx]``, then timed
    in turns (module docstring).  Raises if one differs."""
    from dist_gnn_tpu_torch.ops import gather
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    fns = {"k1": gather.gather_rows, "k2": gather.gather_rows_dma,
           "index_select": lambda t, i: torch.index_select(t, 0, i)}
    want = table[idx.long()]
    row_bytes = table.shape[1] * table.element_size()
    unique_rows = int(torch.unique(idx).numel())
    nbytes = unique_rows * row_bytes + idx.shape[0] * (4 + row_bytes)
    row = {"N": table.shape[0], "F": table.shape[1], "L": idx.shape[0], "dtype": str(table.dtype),
           "unique_rows": unique_rows, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for name, fn in fns.items():
        if not torch.equal(fn(table, idx), want):
            raise RuntimeError(f"{name} differs from table[idx] at {row}")
    del want
    turns = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        fn = fns[name]
        turns[name].append(cuda_time_ms(lambda: fn(table, idx)))
    for name, fn in fns.items():
        kern, _ = profile_device(lambda: fn(table, idx), iters=20)
        row[name] = {"ms": sum(turns[name]) / 2, "ms_turns": turns[name],
                     "device_ms": sum(v for v, _ in kern.values()) / 20 if kern else None,
                     "kernels": sorted(k[:60] for k in kern)}
    return row


def in_step(model, graph, store: torch.Tensor, labels: torch.Tensor, batches: Sequence,
            seed: int, prof_steps: int) -> Dict:
    """The feature gather of SAGE training steps of ``model`` through K1
    and through K2 (rows_per_step 128).  ``batches[0]`` warms both up;
    each later batch takes four steps, in turns K1, K2, K2, K1, with CUDA
    events around the gather inside the step; then the profiler reads the
    gather kernel's device ms over ``prof_steps`` steps of each on
    ``batches[1]``.  The steps train ``model`` (Adam)."""
    from dist_gnn_tpu_torch.ops import gather
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.training import Trainer, masked_nll_loss
    from dist_gnn_tpu_torch.utils.timing import profile_device

    dev = store.device
    tr = Trainer(model=model, fan_out=FAN_OUT, dedup_last=False, device=dev)
    tgen = torch.Generator(device=dev).manual_seed(seed)
    fns = {"k1": gather.gather_rows, "k2": gather.gather_rows_dma}

    def step(s, mk, name, events=None):
        bl, _ = sample_blocks(graph, s, mk, FAN_OUT, False, tgen, dedup_last=False)
        ids = torch.where(bl[-1].frontier_mask, bl[-1].frontier, 0)
        if events is not None:
            events[0].record()
        ft = fns[name](store, ids)
        if events is not None:
            events[1].record()
        lb = torch.where(mk, labels[torch.where(mk, s, 0).long()], 0)
        loss, _ = masked_nll_loss(model, False, bl, ft, lb, mk, tgen)
        tr.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        tr.optimizer.step()

    for name in fns:
        step(*batches[0], name)
    timed = {name: [] for name in fns}
    for s, mk in batches[1:]:
        for name in ("k1", "k2", "k2", "k1"):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            step(s, mk, name, ev)
            timed[name].append(ev)
    torch.cuda.synchronize()
    res = {"timed_batches": len(batches) - 1, "profiled_steps": prof_steps}
    for name, kname in (("k1", "gather_rows_kernel"), ("k2", "gather_rows_dma_kernel")):
        ms = [a.elapsed_time(b) for a, b in timed[name]]
        kern, _ = profile_device(lambda: step(*batches[1], name), iters=prof_steps)
        dev_ms = [v for k_, (v, _) in kern.items() if kname in k_]
        res[name] = {"event_ms_in_step": sum(ms) / len(ms), "event_ms_min": min(ms),
                     "device_ms_in_step": sum(dev_ms) / prof_steps if dev_ms else None}
    res["k2_faster"] = res["k2"]["device_ms_in_step"] < res["k1"]["device_ms_in_step"]
    return res


def main() -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gather_rows needs a CUDA device")
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models.sage import SAGE
    from dist_gnn_tpu_torch.ops import prng
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    arrays, meta = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100,
                                          num_classes=47, train_frac=0.2, seed=0)
    graph = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"]).to_device(dev)
    features = torch.from_numpy(arrays["features"]).to(dev, torch.bfloat16)
    key_gen = torch.Generator().manual_seed(1)
    hop_keys = [prng.random_keys(key_gen, (b,)).to(dev) for b in layer_capacities(BATCH, FAN_OUT)[:3]]
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(dev)
    blocks, _ = sample_blocks(graph, seeds, torch.ones(BATCH, dtype=torch.bool, device=dev), FAN_OUT,
                              False, hop_keys, dedup_last=False)
    safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0)
    bgen = torch.Generator(device=dev).manual_seed(7)
    bench = torch.randn((BENCH_N, BENCH_F), generator=bgen, device=dev)
    bench_idx = torch.randint(0, BENCH_N, (BENCH_L,), generator=bgen, device=dev, dtype=torch.int32)
    res = {}
    for label, table, idx in (("main_path_bf16", features, safe), ("main_path_f32", features.float(), safe),
                              ("bench_bf16", bench.to(torch.bfloat16), bench_idx), ("bench_f32", bench, bench_idx)):
        res[label] = measure(table, idx)
        print(json.dumps({"shape": label, **res[label], "card": smi}), flush=True)
    del bench, bench_idx

    # K1 or K2 for the trainer's gather: SAGE steps (chip_smoke's training
    # batches and model) in bf16 and in f32
    labels = torch.from_numpy(arrays["labels"]).to(dev)
    batches = list(itertools.islice(
        SeedGenerator(arrays["train_idx"], BATCH, shuffle=True, drop_last=True, device=dev)
        .epoch(torch.Generator(device=dev).manual_seed(100)), 9))
    sage = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(4), device=dev)
    sage32 = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), device=dev)
    sage32.load_state_dict(sage.state_dict())
    res["in_step"] = {"bf16": in_step(sage, graph, features, labels, batches, 60, prof_steps=4),
                      "f32": in_step(sage32, graph, features.float(), labels, batches, 61, prof_steps=4)}
    print(json.dumps({"in_step": res["in_step"], "card": smi}), flush=True)
    return res


if __name__ == "__main__":
    main()
