"""Node-range-sharded graph structure and owner-side sampling.

Counterpart of ``dist_gnn_tpu/parallel/graph_dist.py``.  Rank ``d`` holds
the CSC rows ``[d*S, (d+1)*S)`` as a compact sub-CSC whose ``indices`` keep
*global* neighbour ids.  Sampling moves to the owner: seeds are bucketed by
owner and shipped in the feature exchange's request table
(``parallel/feature_store.make_request``); the owner samples k neighbours
per requested row with the port's ``sample_neighbors`` (K6 uniform, K8
weighted with alias tables, K7 weighted without) and ships back only the
[*, k] ids.  Rounds repeat until every seed is served, reusing the owner's
table keys, so a spill round draws what the first would have drawn.

Optional **hot tier**: rows cached on a rank (their own compact sub-CSC,
with alias tables when weighted) are sampled there without the exchange
(:func:`sample_neighbors_cached`).

Keys: where the JAX package derives the owner's key as ``fold_in(key,
me)`` and the hot tier's as ``fold_in(fold_in(key, 1), me)``, the port
takes a ``torch.Generator`` (each rank its own) or the keys themselves,
so a test can inject each rank's JAX keys: for the owner, the keys of one
``sample_neighbors`` call on the flat ``[n * budget]`` request table; for
the hot tier, those of one call on the rank's seeds.

The JAX package pads every shard to the largest shard's edge count for
static shapes; here each rank holds its own sub-CSC unpadded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph, HostGraph
from dist_gnn_tpu_torch.ops.sampling import SampledNeighbors, sample_neighbors, sampler_keys
from dist_gnn_tpu_torch.parallel.feature_store import (
    _probe,
    make_request,
    request_budget,
    return_response,
    shard_rows,
)
from dist_gnn_tpu_torch.parallel.mesh import Mesh, check_axis
from dist_gnn_tpu_torch.utils import native


def _sub_csc(rows: np.ndarray, pad_to: int, indptr64, hg: HostGraph):
    """``(indptr, indices, probs, alias_prob, alias_idx)`` of the given rows
    as numpy arrays, ``indptr`` padded with its last value to ``pad_to + 1``
    entries (int32 below 2**31 edges), alias tables when weighted."""
    sp, si, spr = native.extract_subcsc(rows, indptr64, hg.indices, hg.probs)
    if len(rows) < pad_to:
        sp = np.concatenate([sp, np.full(pad_to - len(rows), sp[-1], sp.dtype)])
    ap = ai = None
    if hg.probs is not None:
        if len(si):
            ap, ai = native.build_alias(sp.astype(np.int64), spr)
        else:
            ap, ai = np.zeros(0, np.float32), np.zeros(0, np.int32)
    ptr = sp.astype(np.int32 if len(si) < 2**31 else np.int64)
    return ptr, si.astype(np.int32), spr, ap, ai


@dataclasses.dataclass
class ShardedGraph:
    """This rank's rows of the CSC (``indptr`` [S+1], ``indices`` [nnz]
    global ids, ``probs`` and alias tables when weighted) and, optionally,
    its hot tier, all on the rank's device.  Local row ``i`` is global row
    ``rank * shard_size + i``."""

    indptr: torch.Tensor
    indices: torch.Tensor
    probs: Optional[torch.Tensor]
    mesh: Mesh
    shard_size: int
    num_nodes: int
    max_degree: int
    alias_prob: Optional[torch.Tensor] = None
    alias_idx: Optional[torch.Tensor] = None
    hot_sorted: Optional[torch.Tensor] = None  # [C] sorted hot ids (INVALID tail)
    hot_indptr: Optional[torch.Tensor] = None  # [C+1]
    hot_indices: Optional[torch.Tensor] = None
    hot_probs: Optional[torch.Tensor] = None
    hot_max_degree: int = 0
    hot_alias_prob: Optional[torch.Tensor] = None
    hot_alias_idx: Optional[torch.Tensor] = None

    @staticmethod
    def build(hg: HostGraph, mesh: Mesh, axis_name="data", hot_ids: Optional[np.ndarray] = None) -> "ShardedGraph":
        """Every rank builds from the same host graph and keeps its own
        shard (by the port's native ``extract_subcsc`` and, for a weighted
        graph, ``build_alias`` per shard) and, with ``hot_ids`` ([n, C],
        INVALID padded, e.g. ``build_cache_plan``'s), its row of hot ids
        with their sub-CSC and alias tables.  ``axis_name`` is ``'data'``
        or, on a two-tier mesh, ``('host', 'data')``: either way the
        shards run over the flat world (rank ``r`` holds shard ``r``) and
        the owner-side exchange stays flat, as JAX's does over the tuple
        axis."""
        check_axis(mesh, axis_name)
        n, me = mesh.size, mesh.rank
        shard = shard_rows(hg.num_nodes, n)
        indptr64 = np.asarray(hg.indptr, dtype=np.int64)
        dev = mesh.device

        def put(a):
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        lo = me * shard
        rows = np.arange(lo, max(lo, min(hg.num_nodes, lo + shard)), dtype=np.int32)
        ptr, idx, pr, ap, ai = _sub_csc(rows, shard, indptr64, hg)
        hot = {}
        if hot_ids is not None:
            hot_ids = np.asarray(hot_ids, np.int32)
            if hot_ids.shape[0] != n:
                raise ValueError(f"hot_ids has {hot_ids.shape[0]} rows for {n} ranks")
            C = hot_ids.shape[1]
            mine = np.sort(hot_ids[me]).astype(np.int32)  # INVALID_ID sorts last
            hptr, hidx, hpr, hap, hai = _sub_csc(mine[mine != INVALID_ID], C, indptr64, hg)
            every = hot_ids[hot_ids != INVALID_ID]
            deg = indptr64[every + 1] - indptr64[every] if len(every) else np.zeros(1, np.int64)
            hot = dict(hot_sorted=put(mine), hot_indptr=put(hptr), hot_indices=put(hidx), hot_probs=put(hpr),
                       hot_max_degree=max(1, int(deg.max())), hot_alias_prob=put(hap), hot_alias_idx=put(hai))
        return ShardedGraph(
            indptr=put(ptr), indices=put(idx), probs=put(pr), mesh=mesh, shard_size=shard,
            num_nodes=hg.num_nodes, max_degree=hg.max_degree, alias_prob=put(ap), alias_idx=put(ai), **hot,
        )

    def local_graph(self) -> Graph:
        """This rank's sub-CSC as a :class:`Graph` of ``shard_size`` rows."""
        return Graph(indptr=self.indptr, indices=self.indices, probs=self.probs, num_nodes=self.shard_size,
                     num_edges=int(self.indices.shape[0]), max_degree=self.max_degree,
                     alias_prob=self.alias_prob, alias_idx=self.alias_idx)

    def hot_graph(self) -> Graph:
        """The hot tier's sub-CSC as a :class:`Graph`, row ``i`` the i-th
        sorted hot id."""
        return Graph(indptr=self.hot_indptr, indices=self.hot_indices, probs=self.hot_probs,
                     num_nodes=int(self.hot_sorted.shape[0]), num_edges=int(self.hot_indices.shape[0]),
                     max_degree=self.hot_max_degree, alias_prob=self.hot_alias_prob,
                     alias_idx=self.hot_alias_idx)

    def local_cached_structure_tensors(self):
        """This rank's hot-tier structure ``(sub_indptr, sub_indices,
        sub_probs or None)``, or None without a hot tier (the reference's
        ``GetLocalCachedStructureTensors``, ``src/sampling/sampler.cc:179-189``)."""
        if self.hot_sorted is None:
            return None
        return self.hot_indptr, self.hot_indices, self.hot_probs

    def local_cached_routing_tensors(self):
        """This rank's id → slot routing table, the sorted hot ids
        (``INVALID_ID`` tail): slot = ``searchsorted(sorted ids, nid)``.
        None without a hot tier (``GetLocalCachedHashTensors``,
        ``sampler.cc:191-196``)."""
        return self.hot_sorted


def sample_neighbors_sharded(
    sgraph: ShardedGraph,
    seeds: torch.Tensor,  # [L] int32 global ids this rank wants sampled
    seed_mask: torch.Tensor,  # [L] bool
    k: int,
    replace: bool,
    key,
    budget: Optional[int] = None,
) -> Tuple[SampledNeighbors, torch.Tensor]:
    """Owner-side sampling: ``(SampledNeighbors [L, k], overflow)``.  Every
    rank calls it in step.  Seeds ride the request table to their owner,
    which samples them on its sub-CSC and returns the ids; lossless rounds
    until every seed is served (one host sync each).  ``key``: a
    ``torch.Generator``, or the keys of one ``sample_neighbors`` call on
    the ``[n * budget]`` table (module doc).  ``overflow`` (0-d int32) is
    the owner samplers' own shortfall (K8's), summed over rounds.  A seed
    outside the table gets an empty row."""
    mesh = sgraph.mesh
    n, S = mesh.size, sgraph.shard_size
    L = seeds.shape[0]
    Pb = budget if budget is not None else request_budget(L, n)
    base = mesh.rank * S
    lg = sgraph.local_graph()
    dev = seeds.device
    keys = sampler_keys(lg, n * Pb, k, replace, key, dev)  # every round draws these
    pending = seed_mask
    ids = torch.full((L, k), INVALID_ID, dtype=torch.int32, device=dev)
    mask = torch.zeros((L, k), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    while True:
        plan, recv, _ = make_request(seeds, pending, mesh, S, Pb)
        local = recv.reshape(-1).to(torch.int64) - base
        mine = (recv.reshape(-1) != INVALID_ID) & (local >= 0) & (local < S)
        nb = sample_neighbors(lg, torch.where(mine, local, INVALID_ID).to(torch.int32), k, replace, keys)
        overflow = overflow + nb.overflow
        served_ids = torch.where(nb.mask, nb.ids, INVALID_ID).reshape(n, Pb, k)
        back = return_response(plan, served_ids, mesh, fill=INVALID_ID)
        served = pending & plan.in_budget
        ids = torch.where(served[:, None], back, ids)
        mask = torch.where(served[:, None], back != INVALID_ID, mask)
        pending = pending & ~served
        if mesh.sum_to_host(pending.sum()) == 0:
            return SampledNeighbors(ids=ids, mask=mask), overflow


def sample_neighbors_cached(
    sgraph: ShardedGraph,
    seeds: torch.Tensor,
    seed_mask: torch.Tensor,
    k: int,
    replace: bool,
    key,
    budget: Optional[int] = None,
) -> Tuple[SampledNeighbors, torch.Tensor]:
    """Hot rows sampled on this rank, the rest owner-side
    (:func:`sample_neighbors_sharded`): ``(SampledNeighbors, overflow)``.
    ``key``: a ``torch.Generator``, or ``(hot keys, owner keys)`` — the
    keys of one ``sample_neighbors`` call on this rank's [L] seeds over the
    hot sub-CSC, and the owner's table keys.  Without a hot tier it is
    :func:`sample_neighbors_sharded` (and ``key`` the owner keys)."""
    if sgraph.hot_sorted is None:
        return sample_neighbors_sharded(sgraph, seeds, seed_mask, k, replace, key, budget)
    hot_key, owner_key = (key, key) if isinstance(key, torch.Generator) else key
    pos, hit = _probe(sgraph.hot_sorted, seeds, seed_mask)
    local_rows = torch.where(hit, pos, INVALID_ID).to(torch.int32)
    nb_hot = sample_neighbors(sgraph.hot_graph(), local_rows, k, replace, hot_key)
    miss_seeds = torch.where(hit, INVALID_ID, seeds)
    nb_miss, overflow = sample_neighbors_sharded(
        sgraph, miss_seeds, seed_mask & ~hit, k, replace, owner_key, budget
    )
    ids = torch.where(hit[:, None], nb_hot.ids, nb_miss.ids)
    mask = torch.where(hit[:, None], nb_hot.mask, nb_miss.mask)
    return SampledNeighbors(ids=ids, mask=mask), overflow + nb_hot.overflow
