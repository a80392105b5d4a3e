"""Node "heat" (expected access frequency) estimation.

Counterpart of ``dist_gnn_tpu/ops/heat.py`` (the reference's heat kernels
``preprocess_heat.cu`` and their caller ``cache_value.py:6-53``): per sampling
hop, in reverse fanout order, every edge (row -> src) of a hot row adds
``min(1, heat[row] * k / deg(row))`` (uniform) or ``min(1, heat[row] * k *
p_e / sum_p(row))`` (biased) to its source node's frontier heat; then

    sampling_heat += seeds_heat
    seeds_heat    += frontier_heat

and finally ``feature_heat = sampling_heat + last frontier_heat``.

Edges are walked in chunks of ``DEFAULT_CHUNK_EDGES``: each chunk finds
its edges' rows by ``searchsorted(indptr, e)`` and ``index_add_``s the
[D, chunk] messages into a [D, N] f32 accumulator, so no [nnz] edge→row
array is ever built and all D seed partitions share one edge sweep per
hop.  :func:`get_node_heat_all_host` streams the edges from host memory
through pinned buffers for graphs whose CSC does not fit the card.  This
is a one-time planning pass with no Pallas counterpart, so it is plain
PyTorch.  Sums run in another order than JAX's scatter: results agree to
f32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import Graph
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device
from dist_gnn_tpu_torch.utils.staging import PinnedRing

# Edges per chunk of the streamed propagation: peak memory per chunk is
# O(D * chunk), independent of nnz.
DEFAULT_CHUNK_EDGES = 1 << 20


def _chunk_rows(indptr: torch.Tensor, e0: int, e1: int) -> torch.Tensor:
    """Row of every edge in [e0, e1) (int64), by binary search."""
    e = torch.arange(e0, e1, dtype=indptr.dtype, device=indptr.device)
    rows = torch.searchsorted(indptr, e, right=True) - 1
    return torch.clamp(rows, 0, indptr.shape[0] - 2)


def _row_prob_sums(graph: Graph, chunk: int) -> torch.Tensor:
    """Per-row sum of edge probs [N] f32, streamed."""
    acc = torch.zeros(graph.num_nodes, dtype=torch.float32, device=graph.indptr.device)
    for e0 in range(0, graph.num_edges, chunk):
        e1 = min(e0 + chunk, graph.num_edges)
        acc.index_add_(0, _chunk_rows(graph.indptr, e0, e1), graph.probs[e0:e1])
    return acc


def _row_val(seeds_heat, num_picks, deg, denom):
    """Per-row message factor [D, N]: the uniform message itself, or the
    biased message's factor before the per-edge ``min(1, . * p_e)``."""
    if denom is not None:
        return seeds_heat * num_picks / denom[None, :]
    safe_deg = torch.where(deg > 0, deg, 1.0)
    return torch.clamp(seeds_heat * num_picks / safe_deg[None, :], max=1.0)


def _denom(row_prob_sum: torch.Tensor) -> torch.Tensor:
    return torch.where(row_prob_sum > 0, row_prob_sum, 1.0)


def frontier_heat_all(
    graph: Graph,
    seeds_heat: torch.Tensor,  # [D, N]
    num_picks: int,
    chunk: int = DEFAULT_CHUNK_EDGES,
    row_prob_sum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One hop of heat propagation for D seed sets at once: [D, N] f32.
    ``row_prob_sum`` (biased graphs) may be passed to share it across
    hops."""
    nnz = graph.num_edges
    chunk = min(chunk, max(nnz, 1))
    deg = (graph.indptr[1:] - graph.indptr[:-1]).to(torch.float32)
    denom = None
    if graph.probs is not None:
        if row_prob_sum is None:
            row_prob_sum = _row_prob_sums(graph, chunk)
        denom = _denom(row_prob_sum)
    row_val = _row_val(seeds_heat, num_picks, deg, denom)
    acc = torch.zeros_like(seeds_heat, dtype=torch.float32)
    for e0 in range(0, nnz, chunk):
        e1 = min(e0 + chunk, nnz)
        vals = row_val[:, _chunk_rows(graph.indptr, e0, e1)]  # [D, chunk]
        if graph.probs is not None:
            vals = torch.clamp(vals * graph.probs[e0:e1][None, :], max=1.0)
        acc.index_add_(1, graph.indices[e0:e1].long(), vals)
    return acc


def get_node_heat_all(
    graph: Graph,
    seeds_heat: torch.Tensor,  # [D, N] initial (1.0 at each partition's seeds)
    fan_out,
    chunk: int = DEFAULT_CHUNK_EDGES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sampling_heat, feature_heat) for D seed partitions, each [D, N],
    on ``graph``'s device: one streamed edge sweep per hop serves all D."""
    row_prob_sum = (
        _row_prob_sums(graph, min(chunk, max(graph.num_edges, 1)))
        if graph.probs is not None
        else None
    )
    sampling_heat = torch.zeros_like(seeds_heat)
    frontier_heat = torch.zeros_like(seeds_heat)
    for k in reversed(list(fan_out)):
        frontier_heat = frontier_heat_all(graph, seeds_heat, k, chunk, row_prob_sum)
        sampling_heat = sampling_heat + seeds_heat
        seeds_heat = seeds_heat + frontier_heat
    return sampling_heat, sampling_heat + frontier_heat


def _host_chunk_rows(indptr64: np.ndarray, e0: int, e1: int) -> np.ndarray:
    """Row index of every edge in [e0, e1) on the host: O(rows + chunk)
    work by repeating over the spanned rows, no per-edge search."""
    r0 = max(int(np.searchsorted(indptr64, e0, side="right")) - 1, 0)
    r1 = int(np.searchsorted(indptr64, e1, side="left"))
    spans = np.clip(indptr64[r0 : r1 + 1], e0, e1)
    return np.repeat(np.arange(r0, r1, dtype=np.int32), np.diff(spans).astype(np.int64))


def get_node_heat_all_host(
    hg,  # HostGraph — indptr/indices/probs stay in host memory (numpy or memmap)
    seeds_heat_np: np.ndarray,  # [D, N] float32 initial heats
    fan_out,
    chunk: int = DEFAULT_CHUNK_EDGES,
    device_budget_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Heat planning for graphs whose CSC does not fit the device: each
    edge chunk (its rows, sources and probs) goes through pinned buffers to
    ``device`` (default: the card), which holds only O(Dg * N) state, the
    group size Dg chosen so that four [Dg, N] f32 arrays fit
    ``device_budget_bytes``.  Partitions propagate independently, so
    grouping is exact.  Returns (sampling_heat, feature_heat) as numpy
    [D, N]."""
    dev = resolve_device(device)
    D, N = seeds_heat_np.shape
    nnz = int(hg.num_edges)
    indptr64 = np.asarray(hg.indptr, dtype=np.int64)
    biased = hg.probs is not None
    chunk = int(min(chunk, max(nnz, 1)))
    if device_budget_bytes is not None:
        Dg = max(1, min(D, int((device_budget_bytes - 8 * N) // (4 * N * 4))))
    else:
        Dg = D
    ring = PinnedRing(dev)

    def edge_chunks(with_srcs: bool):
        """Each chunk's (rows, srcs, probs) on the device; srcs and probs
        are None where not asked for or not weighted."""
        for e0 in range(0, nnz, chunk):
            e1 = min(e0 + chunk, nnz)
            i = ring.acquire()
            rows_np = _host_chunk_rows(indptr64, e0, e1)
            host = {"rows": (rows_np, torch.int64)}
            if with_srcs:
                host["srcs"] = (np.asarray(hg.indices[e0:e1]), torch.int64)
            if biased:
                host["probs"] = (np.asarray(hg.probs[e0:e1]), torch.float32)
            out = {}
            for name, (a, dtype) in host.items():
                buf = ring.buffer(i, name, (e1 - e0,), dtype)
                buf.copy_(torch.from_numpy(a))
                out[name] = buf.to(dev, non_blocking=True)
            ring.release(i)
            yield out["rows"], out.get("srcs"), out.get("probs")

    denom = None
    if biased:
        prob_sum = torch.zeros(N, dtype=torch.float32, device=dev)
        for rows, _, p in edge_chunks(False):
            prob_sum.index_add_(0, rows, p)
        denom = _denom(prob_sum)
    deg = torch.from_numpy(np.diff(indptr64).astype(np.float32)).to(dev)
    samp_out = np.zeros((D, N), np.float32)
    feat_out = np.zeros((D, N), np.float32)
    for g0 in range(0, D, Dg):
        g1 = min(g0 + Dg, D)
        seeds = torch.from_numpy(np.ascontiguousarray(seeds_heat_np[g0:g1], np.float32)).to(dev)
        sampling = torch.zeros_like(seeds)
        frontier = torch.zeros_like(seeds)
        for k in reversed(list(fan_out)):
            row_val = _row_val(seeds, k, deg, denom)
            frontier = torch.zeros_like(seeds)
            for rows, srcs, p in edge_chunks(True):
                vals = row_val[:, rows]
                if p is not None:
                    vals = torch.clamp(vals * p[None, :], max=1.0)
                frontier.index_add_(1, srcs, vals)
            sampling = sampling + seeds
            seeds = seeds + frontier
        samp_out[g0:g1] = sampling.cpu().numpy()
        feat_out[g0:g1] = (sampling + frontier).cpu().numpy()
    return samp_out, feat_out


def frontier_heat_step(graph: Graph, seeds_heat: torch.Tensor, num_picks: int) -> torch.Tensor:
    """One hop of heat propagation; returns frontier_heat [num_nodes]."""
    return frontier_heat_all(graph, seeds_heat[None, :], num_picks)[0]


def get_node_heat(graph: Graph, train_nids, fan_out) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sampling_heat, feature_heat), both [num_nodes] f32 on ``graph``'s
    device, in ``cache_value.py:26-53``'s accumulation order."""
    seeds_heat = torch.zeros((1, graph.num_nodes), dtype=torch.float32, device=graph.indptr.device)
    seeds_heat[0, torch.as_tensor(np.asarray(train_nids), device=seeds_heat.device).long()] = 1.0
    s, f = get_node_heat_all(graph, seeds_heat, fan_out)
    return s[0], f[0]
