"""K7 (``ops/sampling.sample_biased``) alone on the card, in both modes,
at the shapes of the weighted bench request.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_k7

The inputs are those of ``chip_smoke.py``'s ``kernels_biased`` phase: the
500k-node ``make_synthetic_dataset(seed=0)`` graph with ``add_random_probs``
weights (|N(0, 1)|, a tenth of them 0 in no row in particular), the hop
seed sets of one weighted request (512 validation seeds, fanout (15, 10,
5), alias sampler, ``Generator(13)``), and K7 on the graph without alias
tables; keys from ``Generator(14)``.  Cases:

* ``hop0``-``hop2``: the request's three hops (k = 5, 10, 15);
* ``all_hub``: 64 seeds that are all the graph's longest row (226,746
  edges), k = 15: its time should follow its edges, not its longest row;
* ``staged``: hop 2's rows cut to their first 128 edges (a host tier's
  staged rows at ``deg_cap`` 128: no row above K7's short-row limit).

Per case and mode: ``ms``, CUDA events around 20 back-to-back calls;
``device_ms``, every kernel a call starts, from the profiler;
``host_us``, the host's time to launch one call; ``kernels``, device ms
per call by kernel.  ``edges`` is the case's rows' degree sum.

The script reads only functions that every tree of the port has, so it
also runs against an older one: ``PYTHONPATH=<that tree> python3 <this
file>``.

``--variants`` times instead the choices of K7's top-k list, without
replacement (the mode that has them), each a build of ``csrc/sampling.cu``
with its own ``-D`` flags: ``reg_batch`` (the default: the register list
for k <= 32 with the batch insert), ``reg`` (the register list, one
insertion at a time) and ``shared`` (the shared-memory list for every k).
The variants run in turns, A B C then C B A, in one process, and their
outputs must be equal.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

FAN_OUT = (15, 10, 5)
VARIANTS = {"reg_batch": (), "reg": ("-DDG_K7_BATCH_INSERT=33",), "shared": ("-DDG_K7_REG_MAX_K=0",)}
BATCH = 512
STAGED_DEG_CAP = 128


def kernel_name(key: str) -> str:
    """A profiler kernel key's function name (``k7_rows_kernel``, ...)."""
    found = re.search(r"(\w+_kernel)\b", key)
    return found.group(1) if found else key[:40]


def measure(fn: Callable[[], object], iters: int = 20) -> Dict:
    """Event ms, device ms, host µs to launch, and device ms by kernel, per
    call of ``fn``."""
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    ms = cuda_time_ms(fn, iters=iters, warmup=3)
    kernels, _ = profile_device(fn, iters=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return {
        "ms": ms,
        "device_ms": sum(v for v, _ in kernels.values()) / 10,
        "host_us": host_us,
        "kernels": {kernel_name(k): v / 10 for k, (v, _) in kernels.items()},
    }


def cases(cuda: torch.device) -> Dict:
    """The cases' (graph, seeds, k) on the card."""
    from dist_gnn_tpu_torch.dataloading.preprocess import add_random_probs, make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.utils import native

    arrays, _ = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100, num_classes=47,
                                       train_frac=0.2, seed=0)
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    probs = add_random_probs(hg.num_edges, 0)
    ap, ai = native.build_alias(hg.indptr, probs)
    graph_k7 = dataclasses.replace(hg.to_device(cuda), probs=torch.from_numpy(probs).to(cuda))
    graph_w = dataclasses.replace(graph_k7, alias_prob=torch.from_numpy(ap).to(cuda),
                                  alias_idx=torch.from_numpy(ai).to(cuda))
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(cuda)
    mask = torch.ones(BATCH, dtype=torch.bool, device=cuda)
    blocks, _ = sample_blocks(graph_w, seeds, mask, FAN_OUT, False,
                              torch.Generator(device=cuda).manual_seed(13), dedup_last=False)
    out = {f"hop{i}": (graph_k7, blk.seeds, kk) for i, (blk, kk) in enumerate(zip(blocks, reversed(FAN_OUT)))}
    deg = np.diff(hg.indptr.astype(np.int64))
    out["all_hub"] = (graph_k7, torch.full((64,), int(np.argmax(deg)), dtype=torch.int32, device=cuda), 15)
    # hop 2's rows, each cut to its first STAGED_DEG_CAP edges, as one compact CSC
    s2 = blocks[2].seeds.cpu().numpy()
    rows = s2[s2 != INVALID_ID].astype(np.int64)
    lo = hg.indptr[rows].astype(np.int64)
    cut = np.minimum(deg[rows], STAGED_DEG_CAP)
    pos = np.concatenate([np.arange(a, a + c) for a, c in zip(lo, cut)])
    st = HostGraph(indptr=np.concatenate([[0], np.cumsum(cut)]), indices=hg.indices[pos], probs=probs[pos])
    out["staged"] = (st.to_device(cuda), torch.arange(len(rows), dtype=torch.int32, device=cuda), 15)
    return out


def run_variants(cuda: torch.device, all_cases: Dict, kgen: torch.Generator) -> Dict:
    """Each case without replacement through each variant's library, in
    turns; ``device_ms`` and ``ms`` a round, and the variants' outputs
    checked equal."""
    from dist_gnn_tpu_torch.kernels import build
    from dist_gnn_tpu_torch.ops import prng, sampling

    load = sampling._lib
    build_s = time.perf_counter()
    for defines in VARIANTS.values():
        build.build_all(("sampling",), defines)
    build_s = time.perf_counter() - build_s
    keys = {name: prng.random_keys(kgen, (s.shape[0],), cuda) for name, (_, s, _) in all_cases.items()}
    res = {name: {v: {"device_ms": [], "ms": []} for v in VARIANTS} for name in all_cases}
    first = {}
    order = list(VARIANTS)
    try:
        for rnd in (order, order[::-1]):
            for v in rnd:
                sampling._lib = lambda defines=VARIANTS[v]: load(defines)
                for name, (g, s, kk) in all_cases.items():
                    out = sampling.sample_biased(g, s, kk, False, keys[name])
                    if name in first:
                        if not (torch.equal(out.ids, first[name].ids) and torch.equal(out.mask, first[name].mask)):
                            raise RuntimeError(f"variant {v} differs on {name}")
                    else:
                        first[name] = out
                    m = measure(lambda: sampling.sample_biased(g, s, kk, False, keys[name]))
                    res[name][v]["device_ms"].append(m["device_ms"])
                    res[name][v]["ms"].append(m["ms"])
    finally:
        sampling._lib = load
    return {"build_s": build_s, "order": order + order[::-1], "cases": res}


def main(variants: bool = False) -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k7 needs a CUDA device")
    from dist_gnn_tpu_torch.ops import prng, sampling

    cuda = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    kgen = torch.Generator(device=cuda).manual_seed(14)
    if variants:
        line = {"bench": "k7_variants", "card": torch.cuda.get_device_name(0), "power": smi,
                **run_variants(cuda, cases(cuda), kgen)}
        print(json.dumps(line))
        return line
    res = {}
    for name, (g, s, kk) in cases(cuda).items():
        B = s.shape[0]
        valid = s != 0x7FFFFFFF
        safe = torch.where(valid, s, 0).long()
        edges = int(torch.where(valid, g.indptr[safe + 1].long() - g.indptr[safe].long(), 0).sum())
        for replace in (False, True):
            key = prng.random_keys(kgen, (B, kk) if replace else (B,), cuda)
            res[f"{name}_{'replace' if replace else 'topk'}"] = {
                "B": B, "k": kk, "edges": edges, "max_degree": g.max_degree,
                **measure(lambda: sampling.sample_biased(g, s, kk, replace, key))}
    line = {"bench": "k7", "card": torch.cuda.get_device_name(0), "power": smi, "cases": res}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(variants="--variants" in sys.argv[1:])
