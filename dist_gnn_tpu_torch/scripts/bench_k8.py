"""K8 (``ops/sampling.sample_biased_alias``) alone on the card, in both
modes, at the shapes of the weighted bench request.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_k8

The inputs are those of ``chip_smoke.py``'s ``kernels_biased`` phase: the
500k-node ``make_synthetic_dataset(seed=0)`` graph with ``add_random_probs``
weights (|N(0, 1)|, a tenth of them 0) and their Walker alias tables, the
hop seed sets of one weighted request (512 validation seeds, fanout (15,
10, 5), alias sampler, ``Generator(13)``); keys from ``Generator(14)``.
Cases:

* ``hop0``-``hop2``: the request's three hops (k = 5, 10, 15);
* ``all_hub``: 64 seeds that are all the graph's longest row (226,746
  edges), k = 15;
* ``shortfall``: hop 2's long rows (degree > 30) as a graph of their own
  whose first edge holds 9/10 of each row's weight, k = 15: the 60 draws
  find fewer than 15 distinct, so every row reads them all;
* ``k40``: hop 2's seeds at k = 40 (above 32: the shared-memory set).

Per case and mode: ``ms``, CUDA events around 20 back-to-back calls;
``device_ms``, every kernel a call starts, from the profiler; ``host_us``,
the host's time to launch one call; ``kernels``, device ms per call by
kernel; ``bytes`` and ``bound_ms``, what the function needs to read and
write (:func:`k8_bytes`) over 3.35 TB/s, with ``bytes_all_draws`` (a long
row charged all 4k draws) beside it; ``ids_sum``, ``valid`` and
``overflow``, so that two trees' outputs can be compared.

The script reads only functions that every tree of the port has, so it
also runs against an older one: ``PYTHONPATH=<that tree> python3 <this
file>``.

``--variants`` times instead K8's build-time choices, each a build of
``csrc/sampling.cu`` with its own ``-D`` flags: ``default``; ``shared``
(the shared-memory set for every k, not the register list);
``dependent`` (alias_idx read only after a rejection, a short row's key
only after a positive weight); ``no_prefetch`` (a row's first bits read
after its indptr pair).  The variants run in turns, in order and then in
reverse, in one process, and their outputs must be equal.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from dist_gnn_tpu_torch.scripts.bench_k7 import measure

FAN_OUT = (15, 10, 5)
BATCH = 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
VARIANTS = {"default": (), "shared": ("-DDG_K8_REG_MAX_K=0",), "dependent": ("-DDG_K8_PAIRED=0",),
            "no_prefetch": ("-DDG_K8_PREFETCH=0",)}
INVALID_ID = 0x7FFFFFFF


def sectors(base_ptr: int, elem: int, positions: torch.Tensor) -> int:
    """Distinct 32-byte sectors of the elements at ``positions``."""
    return int(torch.unique((base_ptr + elem * positions.long()) // 32).numel())


def span_sectors(base_ptr: int, elem: int, lo: torch.Tensor, n: torch.Tensor) -> int:
    """Distinct 32-byte sectors of the element spans [lo, lo + n)."""
    lo, n = lo[n > 0], n[n > 0]
    if lo.numel() == 0:
        return 0
    first = (base_ptr + elem * lo) // 32
    last = (base_ptr + elem * (lo + n) - 1) // 32
    s0 = int(first.min())
    diff = torch.zeros(int(last.max()) - s0 + 2, dtype=torch.int32, device=lo.device)
    diff.index_add_(0, first - s0, torch.ones_like(first, dtype=torch.int32))
    diff.index_add_(0, last - s0 + 1, -torch.ones_like(last, dtype=torch.int32))
    return int((torch.cumsum(diff, 0) > 0).sum())


def needed_draws(draws: torch.Tensor, k: int, rows_at_once: int = 4096) -> torch.Tensor:
    """Which of each row's draws (``[R, T]`` offsets, in draw order) the
    first k distinct need: those up to and including the k-th first
    occurrence, or all T when the row has fewer than k distinct."""
    T = draws.shape[1]
    earlier = torch.tril(torch.ones((T, T), dtype=torch.bool, device=draws.device), diagonal=-1)
    out = []
    for d in torch.split(draws, rows_at_once):
        first = ~((d[:, :, None] == d[:, None, :]) & earlier).any(dim=2)
        before = torch.cumsum(first.to(torch.int32), dim=1) - first.to(torch.int32)
        out.append(before < k)
    return torch.cat(out) if out else torch.zeros_like(draws, dtype=torch.bool)


def k8_bytes(graph, seeds: torch.Tensor, k: int, replace: bool, key) -> Dict:
    """The bytes K8's function must move for these seeds and keys (``key``
    as ``sample_biased_alias`` takes it injected), in distinct 32-byte
    sectors of each array read: a long row's bit pairs, ``alias_prob`` at
    each needed draw and ``alias_idx`` at the needed draws it rejects
    (:func:`needed_draws`; with replacement every draw of a row with an
    edge), a short row's weights and its keys at positive weights, the
    picks' indices, the valid seeds' indptr pairs; the seeds read, ids and
    mask written, and the 4-byte shortfall counter.  ``bytes_all_draws``
    charges a long row all 4k draws, as a design that resolves every draw
    reads."""
    from dist_gnn_tpu_torch.ops import prng, sampling

    B = seeds.shape[0]
    dev = seeds.device
    bits, gum = sampling.alias_keys(key, B, k, replace, dev)
    valid = seeds != INVALID_ID
    safe = torch.where(valid, seeds, 0).long()
    lo = graph.indptr[safe].long()
    dg = torch.where(valid, graph.indptr[safe + 1].long() - lo, 0)
    pos, m = sampling.sample_biased_alias_positions(graph, seeds, k, replace, key)[:2]
    fixed = (sectors(graph.indices.data_ptr(), 4, pos[m])
             + sectors(graph.indptr.data_ptr(), graph.indptr.element_size(),
                       torch.cat([safe[valid], safe[valid] + 1]))) * 32 + B * 4 + B * k * 5
    T = k if replace else 4 * k
    drawn = valid & ((dg > 0) if replace else (dg > 2 * k))
    rows = drawn.nonzero().flatten()
    j = bits[0][rows] % dg[rows][:, None]
    at = lo[rows][:, None] + j
    rejected = ~(prng.bits_to_uniform(bits[1][rows]) < graph.alias_prob[at])
    offs = torch.where(rejected, graph.alias_idx[at].long(), j)
    need = torch.ones_like(at, dtype=torch.bool) if replace else needed_draws(offs, k)

    def draw_bytes(sel):
        bit_pos = (rows[:, None] * T + torch.arange(T, device=dev))[sel]
        return (sectors(bits.data_ptr(), 8, torch.cat([bit_pos, bit_pos + B * T]))
                + sectors(graph.alias_prob.data_ptr(), 4, at[sel])
                + sectors(graph.alias_idx.data_ptr(), 4, at[sel & rejected])) * 32

    out = {"B": B, "k": k, "drawn_rows": int(rows.numel()), "draws_needed": int(need.sum()),
           "draws_all": int(at.numel()), "alias_idx_reads": int((need & rejected).sum())}
    dense = 0
    if not replace:
        short = valid & (dg > 0) & (dg <= 2 * k)
        o = torch.arange(2 * k, device=dev)
        key_read = short[:, None] & (o[None, :] < dg[:, None])
        key_read &= graph.probs[torch.where(key_read, lo[:, None] + o, 0)] > 0
        key_pos = (torch.arange(B, device=dev)[:, None] * (2 * k) + o)[key_read]
        dense = (span_sectors(graph.probs.data_ptr(), 4, lo[short], dg[short])
                 + sectors(gum.data_ptr(), 8, key_pos)) * 32 + 4
        out.update(short_rows=int(short.sum()), keys_read=int(key_read.sum()))
    out["bytes"] = fixed + dense + draw_bytes(need)
    out["bytes_all_draws"] = fixed + dense + draw_bytes(torch.ones_like(need))
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    out["bound_all_draws_ms"] = out["bytes_all_draws"] / HBM_BYTES_PER_S * 1e3
    return out


def graph_inputs(cuda: torch.device):
    """The weighted bench graph (host arrays, its weights, the graph with
    alias tables on the card) and one weighted request's hop seed sets."""
    from dist_gnn_tpu_torch.dataloading.preprocess import add_random_probs, make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.utils import native

    arrays, _ = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100, num_classes=47,
                                       train_frac=0.2, seed=0)
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    probs = add_random_probs(hg.num_edges, 0)
    ap, ai = native.build_alias(hg.indptr, probs)
    graph_w = dataclasses.replace(hg.to_device(cuda), probs=torch.from_numpy(probs).to(cuda),
                                  alias_prob=torch.from_numpy(ap).to(cuda), alias_idx=torch.from_numpy(ai).to(cuda))
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(cuda)
    mask = torch.ones(BATCH, dtype=torch.bool, device=cuda)
    blocks, _ = sample_blocks(graph_w, seeds, mask, FAN_OUT, False,
                              torch.Generator(device=cuda).manual_seed(13), dedup_last=False)
    return hg, probs, graph_w, [blk.seeds for blk in blocks]


def cases(cuda: torch.device, hg, probs: np.ndarray, graph_w, hop_seeds) -> Dict:
    """The cases' (graph, seeds, k) on the card, from :func:`graph_inputs`."""
    from dist_gnn_tpu_torch.graph import HostGraph

    out = {f"hop{i}": (graph_w, s, kk) for i, (s, kk) in enumerate(zip(hop_seeds, reversed(FAN_OUT)))}
    deg = np.diff(hg.indptr.astype(np.int64))
    out["all_hub"] = (graph_w, torch.full((64,), int(np.argmax(deg)), dtype=torch.int32, device=cuda), 15)
    s2 = hop_seeds[2].cpu().numpy()
    rows = s2[s2 != INVALID_ID].astype(np.int64)
    rows = rows[deg[rows] > 2 * 15]
    lo, dg = hg.indptr[rows].astype(np.int64), deg[rows]
    pos = np.concatenate([np.arange(a, a + c) for a, c in zip(lo, dg)])
    ip = np.concatenate([[0], np.cumsum(dg)])
    w = probs[pos].copy()
    w[ip[:-1]] = 0
    w[ip[:-1]] = 9 * np.add.reduceat(w, ip[:-1]) + 1e-3  # the first edge: 9/10 of its row
    sf = HostGraph(indptr=ip, indices=hg.indices[pos], probs=w)
    out["shortfall"] = (sf.to_device(cuda, with_alias=True), torch.arange(len(rows), dtype=torch.int32,
                                                                           device=cuda), 15)
    out["k40"] = (graph_w, hop_seeds[2], 40)
    return out


def alias_key_set(gen: torch.Generator, B: int, k: int, replace: bool, cuda: torch.device):
    """One call's injected keys, drawn as ``sample_biased_alias`` draws them."""
    from dist_gnn_tpu_torch.ops import prng

    bits = prng.random_keys(gen, (2, B, k if replace else 4 * k), cuda)
    return bits if replace else (bits, prng.random_keys(gen, (B, 2 * k), cuda))


def outputs(out) -> Dict:
    return {"ids_sum": int(torch.where(out.mask, out.ids, 0).long().sum()), "valid": int(out.mask.sum()),
            "overflow": int(torch.as_tensor(out.overflow))}


def run_variants(cuda: torch.device, all_cases: Dict, kgen: torch.Generator) -> Dict:
    """Each case and mode through each variant's library, in turns;
    ``device_ms`` and ``ms`` a round, and the variants' outputs checked
    equal."""
    from dist_gnn_tpu_torch.kernels import build
    from dist_gnn_tpu_torch.ops import sampling

    load = sampling._lib
    build_s = time.perf_counter()
    for defines in VARIANTS.values():
        build.build_all(("sampling",), defines)
    build_s = time.perf_counter() - build_s
    runs = {f"{name}_{'replace' if r else 'distinct'}": (g, s, kk, r, alias_key_set(kgen, s.shape[0], kk, r, cuda))
            for name, (g, s, kk) in all_cases.items() for r in (False, True)}
    res = {name: {v: {"device_ms": [], "ms": []} for v in VARIANTS} for name in runs}
    first = {}
    order = list(VARIANTS)
    try:
        for rnd in (order, order[::-1]):
            for v in rnd:
                sampling._lib = lambda defines=VARIANTS[v]: load(defines)
                for name, (g, s, kk, r, key) in runs.items():
                    got = outputs(sampling.sample_biased_alias(g, s, kk, r, key))
                    if first.setdefault(name, got) != got:
                        raise RuntimeError(f"variant {v} differs on {name}: {got} vs {first[name]}")
                    m = measure(lambda: sampling.sample_biased_alias(g, s, kk, r, key))
                    res[name][v]["device_ms"].append(m["device_ms"])
                    res[name][v]["ms"].append(m["ms"])
    finally:
        sampling._lib = load
    return {"build_s": build_s, "order": order + order[::-1], "cases": res}


def main(variants: bool = False) -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k8 needs a CUDA device")
    from dist_gnn_tpu_torch.ops import sampling

    cuda = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    kgen = torch.Generator(device=cuda).manual_seed(14)
    all_cases = cases(cuda, *graph_inputs(cuda))
    if variants:
        line = {"bench": "k8_variants", "card": torch.cuda.get_device_name(0), "power": smi,
                **run_variants(cuda, all_cases, kgen)}
        print(json.dumps(line))
        return line
    res = {}
    for name, (g, s, kk) in all_cases.items():
        for replace in (False, True):
            key = alias_key_set(kgen, s.shape[0], kk, replace, cuda)
            got = sampling.sample_biased_alias(g, s, kk, replace, key)
            res[f"{name}_{'replace' if replace else 'distinct'}"] = {
                **k8_bytes(g, s, kk, replace, key), **outputs(got),
                **measure(lambda: sampling.sample_biased_alias(g, s, kk, replace, key))}
    line = {"bench": "k8", "card": torch.cuda.get_device_name(0), "power": smi, "cases": res}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(variants="--variants" in sys.argv[1:])
