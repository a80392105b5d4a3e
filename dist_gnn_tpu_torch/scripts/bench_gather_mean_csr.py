"""K3-csr (the full-graph row walk, ``gather_mean_csr``) against its plain
version and the walk it replaced.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_gather_mean_csr

on the 500k-node ``make_synthetic_dataset(seed=0)`` graph of
``chip_smoke.py``; ``chip_smoke.py`` also calls :func:`measure` on the
benchmark's ogbn-products-sized graph.

Per width and epilogue (:func:`measure`): the kernel held to its plain
version (largest gap over the plain output's largest magnitude) and to
itself (two calls, the same bits); ``ms`` (CUDA events over calls),
``device_ms`` and ``device_ms_by_op`` (the profiler's time of every
kernel a call launches), ``host_us_per_call``; ``bound_ms``, the bytes the
walk must move (every edge's source row, indices and indptr read once,
every output row written once) over 3.35 TB/s; ``plain_ms``; and
``library_ms``, the walk it replaced: K1 over 2^18-edge chunks, the f32
cast and ``index_add_`` into an [N, F] f32 buffer, then the mean's
division and the cast back.  The plan (``csr_plan``) is built once, as a
pass builds it, and timed apart (``plan_ms``).
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from dist_gnn_tpu_torch.ops import gather
from dist_gnn_tpu_torch.scripts.bench_gather_mean import HBM_BYTES_PER_S, time_call

EDGE_CHUNK = 1 << 18  # the replaced walk's chunk (full_graph_inference's edge_chunk)


def walk_bytes(h: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor) -> int:
    """Bytes one walk must move: each edge's source row and id, indptr, and
    the output rows."""
    row = h.shape[1] * h.element_size()
    return indices.numel() * (row + indices.element_size()) + indptr.numel() * 8 + h.shape[0] * row


def replaced_walk(h: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, erows: torch.Tensor,
                  mean: bool) -> torch.Tensor:
    """The SAGE and GCN walk before K3-csr: K1 per edge chunk, the f32 cast,
    ``index_add_``, then the mean's division and one cast."""
    acc = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    for b0 in range(0, indices.numel(), EDGE_CHUNK):
        acc.index_add_(0, erows[b0 : b0 + EDGE_CHUNK], gather.gather_rows(h, indices[b0 : b0 + EDGE_CHUNK]).float())
    if mean:
        acc = acc / torch.clamp(indptr[1:] - indptr[:-1], min=1).to(torch.float32)[:, None]
    return acc.to(h.dtype)


def rel_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| over max |ref| (0 when both are all 0), in f32."""
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    gap = float((out.float() - ref.float()).abs().max()) if ref.numel() else 0.0
    return gap / scale if scale > 0 else gap


def measure(h: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, mean: bool = True,
            timed: bool = True) -> Dict:
    """The kernel's checks and, when ``timed``, its times (module
    docstring) on one input."""
    torch.cuda.synchronize()
    plan = gather.csr_plan(indptr, indices.numel())
    out = gather.gather_mean_csr(h, indptr, indices, mean, plan)
    again = gather.gather_mean_csr(h, indptr, indices, mean, plan)
    want = gather.gather_mean_csr_plain(h, indptr, indices, mean)
    r = {
        "N": h.shape[0], "F": h.shape[1], "nnz": indices.numel(), "dtype": str(h.dtype).replace("torch.", ""),
        "mean": mean, "rel_err": rel_gap(out, want), "bit_identical": bool(torch.equal(out, again)),
        "light_max": gather.CSR_LIGHT_MAX, "heavy_rows": int(plan.n_heavy), "heavy_edges": int(plan.heavy_edges),
        "bytes": walk_bytes(h, indptr, indices),
    }
    r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
    r["heavy_edges_pct"] = 100.0 * r["heavy_edges"] / max(r["nnz"], 1)
    del out, again, want
    if timed:
        from dist_gnn_tpu_torch.utils.timing import cuda_time_ms

        r.update(time_call(lambda: gather.gather_mean_csr(h, indptr, indices, mean, plan), iters=5, prof_iters=3))
        r["roofline_pct"] = 100.0 * r["bound_ms"] / r["device_ms"] if r["device_ms"] else None
        r["plan_ms"] = cuda_time_ms(lambda: gather.csr_plan(indptr, indices.numel()), iters=5)
        r["plain_ms"] = cuda_time_ms(lambda: gather.gather_mean_csr_plain(h, indptr, indices, mean), iters=2,
                                     warmup=1)
        erows = torch.repeat_interleave(torch.arange(h.shape[0], device=h.device), indptr[1:] - indptr[:-1],
                                        output_size=indices.numel())
        r["library_ms"] = cuda_time_ms(lambda: replaced_walk(h, indptr, indices, erows, mean), iters=2, warmup=1)
        r["library_is"] = "K1 over 2^18-edge chunks, f32 cast, index_add_, division and cast"
        del erows
    torch.cuda.empty_cache()
    return r


def main() -> None:
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset

    dev = torch.device("cuda")
    arrays, _ = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100,
                                       num_classes=47, train_frac=0.2, seed=0)
    indptr = torch.from_numpy(arrays["indptr"]).to(dev, torch.int64)
    indices = torch.from_numpy(arrays["indices"]).to(dev, torch.int32)
    feats = torch.from_numpy(arrays["features"]).to(dev, torch.bfloat16)
    hidden = torch.randn((feats.shape[0], 256), generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev).to(torch.bfloat16)
    for h in (feats, hidden):
        for mean in (True, False):
            print(json.dumps({"K3-csr": measure(h, indptr, indices, mean), "card": torch.cuda.get_device_name(0)}),
                  flush=True)


if __name__ == "__main__":
    main()
