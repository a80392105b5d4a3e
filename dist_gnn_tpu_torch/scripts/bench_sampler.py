"""The sampler at the SAGE bench config's main path, op group by op group.
Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_sampler

The inputs are those of ``chip_smoke.py``'s serving request: the 500k-node
``make_synthetic_dataset(seed=0)`` graph, 512 validation seeds, fanout
(15, 10, 5) without replacement and a dedup-free last hop, hop keys from
``Generator(1)``.

Groups, each on the inputs one ``sample_blocks`` call gives it:

* ``sample_blocks``: the whole call with injected keys, and
  ``sample_blocks_generator``: the call as a step makes it, drawing its
  keys from a CUDA generator;
* ``sample_uniform`` at each hop (K6 on the card where the tree has it),
  and ``feistel`` at each hop: the plain keyed permutation
  (``prng.feistel_permutation``) over the hop's [B, k] slots, which the
  plain sampler runs whole;
* ``relabel`` at hops 0 and 1 (``unique_and_relabel``);
* ``rest``: ``sample_blocks`` less the sum of ``sample_uniform`` and
  ``relabel`` (the dedup-free block, the frontier bookkeeping).

Per group: ``ms``, CUDA events around back-to-back calls; ``device_ms``
and ``kernels_per_call``, every device activity a call starts, from the
profiler; ``wall_ms``, the host clock around calls that each end in a
synchronize; ``busy_share``, device ms over the profiled wall time.

The script reads only functions that every tree of the port has, so it
also runs against an older one: ``PYTHONPATH=<that tree> python3 <this
file>``.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Dict

import torch

FAN_OUT = (15, 10, 5)
BATCH = 512


def time_group(fn: Callable[[], object], iters: int = 5, prof_iters: int = 3) -> Dict:
    """Event ms, device ms, kernels, wall ms and busy share per call."""
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    ms = cuda_time_ms(fn, iters=iters, warmup=1)
    kernels, prof_wall = profile_device(fn, iters=prof_iters)
    dev_ms = sum(v for v, _ in kernels.values())
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    return {
        "ms": ms,
        "wall_ms": sum(walls) / len(walls),
        "device_ms": dev_ms / prof_iters if kernels else None,
        "kernels_per_call": sum(n for _, n in kernels.values()) / prof_iters,
        "busy_share": dev_ms / prof_wall if kernels else None,
        "top_kernels": [[k[:60], v / prof_iters, n / prof_iters] for k, (v, n) in top],
    }


def main() -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_sampler needs a CUDA device")
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
    from dist_gnn_tpu_torch.ops import prng, sampling
    from dist_gnn_tpu_torch.ops.relabel import unique_and_relabel
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    arrays, _ = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100,
                                       num_classes=47, train_frac=0.2, seed=0)
    graph = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"]).to_device(dev)
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(dev)
    mask = torch.ones(BATCH, dtype=torch.bool, device=dev)
    key_gen = torch.Generator().manual_seed(1)
    hop_keys = [prng.random_keys(key_gen, (b,)).to(dev)
                for b in layer_capacities(BATCH, FAN_OUT)[: len(FAN_OUT)]]
    blocks, _ = sample_blocks(graph, seeds, mask, FAN_OUT, False, hop_keys, dedup_last=False)
    step_gen = torch.Generator(device=dev).manual_seed(11)

    res = {
        "sample_blocks": time_group(
            lambda: sample_blocks(graph, seeds, mask, FAN_OUT, False, hop_keys, dedup_last=False)),
        "sample_blocks_generator": time_group(
            lambda: sample_blocks(graph, seeds, mask, FAN_OUT, False, step_gen, dedup_last=False)),
    }
    parts = 0.0
    parts_dev = 0.0
    parts_kernels = 0.0
    for i, (blk, k) in enumerate(zip(blocks, reversed(FAN_OUT))):
        s, key = blk.seeds, hop_keys[i]
        valid = s != INVALID_ID
        safe = torch.where(valid, s, 0).long()
        deg = torch.where(valid, (graph.indptr[safe + 1] - graph.indptr[safe]).to(torch.int32), 0)
        j = torch.arange(k, dtype=torch.int32, device=dev).expand(s.shape[0], k)
        hop = {"B": s.shape[0], "k": k,
               "sample_uniform": time_group(lambda: sampling.sample_uniform(graph, s, k, False, key)),
               "feistel": time_group(lambda: prng.feistel_permutation(j, deg[:, None], key[:, None]))}
        nb = sampling.sample_uniform(graph, s, k, False, key)
        groups = [hop["sample_uniform"]]
        if i < len(FAN_OUT) - 1:  # the last hop is dedup-free: no relabel
            hop["relabel"] = time_group(lambda: unique_and_relabel(s, nb.ids, nb.mask))
            groups.append(hop["relabel"])
        for g in groups:
            parts += g["ms"]
            parts_dev += g["device_ms"] or 0.0
            parts_kernels += g["kernels_per_call"]
        res[f"hop{i}"] = hop
    whole = res["sample_blocks"]
    res["rest"] = {"ms": whole["ms"] - parts, "device_ms": (whole["device_ms"] or 0.0) - parts_dev,
                   "kernels_per_call": whole["kernels_per_call"] - parts_kernels}
    for name, row in res.items():
        print(json.dumps({"group": name, **row, "card": smi}), flush=True)
    return res


if __name__ == "__main__":
    main()
