"""K6 (``ops/sampling.sample_uniform``) and the slot transpose
(``ops/gather.slot_transpose``, which K3's backward reads) alone on the
card.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_k6

The inputs are those of ``chip_smoke.py``'s serving request: the 500k-node
``make_synthetic_dataset(seed=0)`` graph, 512 validation seeds, fanout
(15, 10, 5) with a dedup-free last hop, hop keys from ``Generator(1)``.
Cases:

* ``k6_hop0``-``k6_hop2``: the request's three hops (k = 5, 10, 15),
  without replacement on the request's keys (``_distinct``) and with
  replacement on [B, k] keys from ``Generator(2)`` (``_replace``);
* ``k6_hub``: 64 seeds that are all the graph's longest row (226,746
  edges), k = 15: the Feistel walk on the largest domain;
* ``tr_layer1``, ``tr_layer2``: the slot transpose of SAGE layers 1 and 2
  (the blocks' slot tables into their source rows);
* ``tr_hub``: a 2^21-slot table (131,072 rows x 16) over 400,000 source
  rows, one of which 13,108 slots name (about 11,800 of them valid).

Per case: ``ms``, CUDA events around 20 back-to-back calls; ``queued_ms``,
the same with the calls queued behind a device sleep, so it times the
stream's work and the gaps between its launches and not the host
(:func:`queued_ms`); ``device_ms``, every kernel and memset a call puts
on the card, from the profiler (without the gaps between them);
``host_us``, the host's time to launch one call; ``kernels``, device ms
per call by kernel; ``bytes`` and ``bound_ms``, what the function must
read and write over 3.35 TB/s (K6: the distinct 32-byte sectors of
indices its taken slots read and of indptr its valid seeds read, every
seed and key, ids and mask written; the transpose: slots and mask read,
offsets, entries, their divisors and each row's divisor written); and a
digest of the output to compare trees (K6: ``valid``, ``ids_sum`` and a
position-weighted sum of the ids; the transpose: a sum over the offsets
and one over each list sorted, both position-weighted, mod 2^31 - 1).
``k6_host_parts_us`` times pieces of K6's launch path alone, at hop 2.

The script reads only functions that every tree of the port has, so it
also runs against an older one: ``PYTHONPATH=<that tree> python3 <this
file>``.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Dict

import numpy as np
import torch

from dist_gnn_tpu_torch.scripts.bench_k7 import measure
from dist_gnn_tpu_torch.scripts.bench_k8 import sectors

FAN_OUT = (15, 10, 5)
BATCH = 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
INVALID_ID = 0x7FFFFFFF
P = 2**31 - 1
HUB_S, HUB_K, HUB_CAP, HUB_ROW, HUB_EVERY = 131_072, 16, 400_000, 7, 160
SLEEP_CYCLES = 20_000_000  # ~11 ms of device sleep at 1.76 GHz, behind which calls queue


def weighted(values: torch.Tensor) -> int:
    """sum((v mod P) * (i + 1)) mod P over a 1-D int tensor: a digest that
    sees the order of ``values``."""
    v = values.long() % P
    i = torch.arange(1, v.numel() + 1, device=v.device) % P
    return int(((v * i) % P).sum() % P)


def k6_digest(out) -> Dict:
    ids = torch.where(out.mask, out.ids, 0).long()
    return {"valid": int(out.mask.sum()), "ids_sum": int(ids.sum()), "ids_weighted": weighted(ids.flatten())}


def transpose_digest(tr, cap: int, n_slots: int) -> Dict:
    """Offsets as they are, each list sorted (the card's order within a
    list is its atomics')."""
    off = tr.offsets.long()
    n = int(off[-1])
    rows = torch.repeat_interleave(torch.arange(cap, device=off.device), off[1:] - off[:-1])
    lists = torch.sort(rows * (n_slots + 1) + tr.entries[:n].long())[0]
    return {"entries": n, "offsets_weighted": weighted(off), "lists_weighted": weighted(lists)}


def k6_bytes(graph, seeds: torch.Tensor, k: int, replace: bool, key: torch.Tensor) -> int:
    from dist_gnn_tpu_torch.ops import sampling

    pos, m = sampling.plain_positions(graph, seeds, k, replace, key)
    valid = seeds != INVALID_ID
    sv = seeds[valid].long()
    B = seeds.shape[0]
    return ((sectors(graph.indices.data_ptr(), 4, pos[m])
             + sectors(graph.indptr.data_ptr(), graph.indptr.element_size(), torch.cat([sv, sv + 1]))) * 32
            + B * 4 + key.numel() * 8 + B * k * 5)


def transpose_bytes(slots: torch.Tensor, mask: torch.Tensor, cap: int) -> int:
    S, k = slots.shape
    return S * k * 5 + (cap + 1) * 4 + int(mask.sum()) * 8 + S * 4


def inputs(cuda: torch.device):
    """The bench graph on the card and one request's blocks and hop keys."""
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.ops import prng
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks

    arrays, _ = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100, num_classes=47,
                                       train_frac=0.2, seed=0)
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    graph = hg.to_device(cuda)
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(cuda)
    key_gen = torch.Generator().manual_seed(1)
    hop_keys = [prng.random_keys(key_gen, (b,)).to(cuda) for b in layer_capacities(BATCH, FAN_OUT)[: len(FAN_OUT)]]
    blocks, _ = sample_blocks(graph, seeds, torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False,
                              hop_keys, dedup_last=False)
    return hg, graph, blocks, hop_keys


def cases(cuda: torch.device, hg, graph, blocks, hop_keys) -> Dict[str, Dict]:
    """Each case's call, its digest, its bytes, and whether a SAGE step
    runs it (``main_path``), from :func:`inputs`."""
    from dist_gnn_tpu_torch.ops import gather, prng, sampling

    rgen = torch.Generator().manual_seed(2)
    out = {}

    def k6_case(name, seeds, kk, replace, key, main_path=False):
        out[name] = {"kind": "k6", "B": seeds.shape[0], "k": kk, "main_path": main_path,
                     "call": lambda: sampling.sample_uniform(graph, seeds, kk, replace, key),
                     "digest": lambda res: k6_digest(res),
                     "bytes": k6_bytes(graph, seeds, kk, replace, key)}

    for i, (blk, kk) in enumerate(zip(blocks, reversed(FAN_OUT))):
        B = blk.seeds.shape[0]
        k6_case(f"k6_hop{i}_distinct", blk.seeds, kk, False, hop_keys[i], main_path=True)
        k6_case(f"k6_hop{i}_replace", blk.seeds, kk, True, prng.random_keys(rgen, (B, kk), cuda))
    hub = torch.full((64,), int(np.argmax(np.diff(hg.indptr.astype(np.int64)))), dtype=torch.int32, device=cuda)
    k6_case("k6_hub_distinct", hub, 15, False, prng.random_keys(rgen, (64,), cuda))

    def tr_case(name, slots, mask, cap, main_path=False):
        n_slots = slots.numel()
        out[name] = {"kind": "transpose", "S": slots.shape[0], "k": slots.shape[1], "cap": cap,
                     "main_path": main_path,
                     "call": lambda: gather.slot_transpose(slots, mask, cap),
                     "digest": lambda res: transpose_digest(res, cap, n_slots),
                     "bytes": transpose_bytes(slots, mask, cap)}

    for l, blk in enumerate(reversed(blocks)):
        if l > 0:  # layer 0's input needs no gradient: a step builds no transpose there
            tr_case(f"tr_layer{l}", blk.neigh_slots, blk.neigh_mask, blk.num_src, main_path=True)
    slots, mask, named = hub_table(cuda)
    tr_case("tr_hub", slots, mask, HUB_CAP)
    out["tr_hub"]["hub_named"] = named
    return out


def hub_table(cuda: torch.device):
    """The ``tr_hub`` case's [HUB_S, HUB_K] slot table over HUB_CAP rows,
    every HUB_EVERY-th slot naming row HUB_ROW, 9 in 10 slots valid
    (``Generator(4)``); raises unless more than 10,000 valid slots name
    the hub row.  Returns slots, mask and that count."""
    tgen = torch.Generator(device=cuda).manual_seed(4)
    slots = torch.randint(0, HUB_CAP, (HUB_S, HUB_K), device=cuda, dtype=torch.int32, generator=tgen)
    slots.view(-1)[::HUB_EVERY] = HUB_ROW
    mask = torch.rand(HUB_S, HUB_K, device=cuda, generator=tgen) < 0.9
    named = int((slots[mask] == HUB_ROW).sum())
    if named <= 10_000:
        raise RuntimeError(f"the hub row is named by {named} valid slots, not more than 10,000")
    return slots, mask, named


def host_parts(graph, seeds: torch.Tensor, k: int, key: torch.Tensor) -> Dict[str, float]:
    """Host µs of pieces of one K6 launch path, each alone."""
    from dist_gnn_tpu_torch.kernels.launch import stream_of
    from dist_gnn_tpu_torch.ops import sampling
    from dist_gnn_tpu_torch.scripts.bench_gather_mean import _host_us

    B = seeds.shape[0]
    lib = sampling._lib()
    fn = lib.dg_sample_uniform
    args = (0, 0, 0, 0, 0, 0, 0, 0, k, 1, 1, 0, 0)  # B = 0: returns at once
    return {
        "check_graph": _host_us(lambda: sampling._check_graph(graph, seeds)),
        "draw_keys_injected": _host_us(lambda: sampling.draw_keys(key, (B,), seeds.device)),
        "empty_ids_and_mask": _host_us(lambda: (torch.empty((B, k), dtype=torch.int32, device=seeds.device),
                                                torch.empty((B, k), dtype=torch.bool, device=seeds.device))),
        "new_empty_ids_and_mask": _host_us(lambda: (seeds.new_empty((B, k)),
                                                    seeds.new_empty((B, k), dtype=torch.bool))),
        "lib": _host_us(sampling._lib),
        "stream_of": _host_us(lambda: stream_of(seeds)),
        "ctypes_call_13_args": _host_us(lambda: fn(*args)),
        "whole_call": _host_us(lambda: sampling.sample_uniform(graph, seeds, k, False, key)),
    }


def queued_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Milliseconds per call of ``fn`` with the calls queued back to back on
    the stream: the host enqueues them behind a sleep on the device, so the
    span between two events times the device's work and the gaps between
    its launches, not the host's enqueueing.  Raises if the host was not
    done before the sleep was."""
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if host_ms >= slept.elapsed_time(start):
        raise RuntimeError(f"the host took {host_ms} ms to enqueue, longer than the device's sleep")
    return start.elapsed_time(end) / iters


def run_cases(all_cases: Dict[str, Dict]) -> Dict:
    res = {}
    for name, c in all_cases.items():
        got = c["call"]()
        row = {key: v for key, v in c.items() if key not in ("call", "digest")}
        row.update(c["digest"](got), **measure(c["call"]), queued_ms=queued_ms(c["call"]),
                   bound_ms=c["bytes"] / HBM_BYTES_PER_S * 1e3)
        res[name] = row
    return res


def main() -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k6 needs a CUDA device")
    cuda = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    hg, graph, blocks, hop_keys = inputs(cuda)
    all_cases = cases(cuda, hg, graph, blocks, hop_keys)
    line: Dict = {"bench": "k6", "card": torch.cuda.get_device_name(0), "power": smi,
                  "cases": run_cases(all_cases),
                  "k6_host_parts_us": host_parts(graph, blocks[2].seeds, FAN_OUT[0], hop_keys[2])}
    line["main_path_sums"] = {
        kind: {key: sum(r[key] for r in line["cases"].values() if r["kind"] == kind and r["main_path"])
               for key in ("ms", "device_ms", "host_us", "bound_ms")}
        for kind in ("k6", "transpose")}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
