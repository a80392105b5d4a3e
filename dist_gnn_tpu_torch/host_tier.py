"""Host-resident base tier: graphs and features bigger than device memory.

Counterpart of ``dist_gnn_tpu/host_tier.py``, after the reference's core
premise: the full graph and its features live in host memory, the hottest
nodes' structure and features are cached on the card, and each row is
served from the card or from the host.

* The **hot tier** (chosen by the heat/value policy, ``cache/``) is on
  the card and served by K1 (features) or by the graph's sampler
  (structure: K6, or K8 from the hot rows' own alias tables on a weighted
  graph).
* The **base tier** stays in host memory (numpy or ``np.memmap``) and is
  never uploaded whole.
* Each batch's feature misses are gathered on the host by the native
  OpenMP gather (``utils/native.gather_rows``) into one of two pinned
  slabs and copied to the card with ``non_blocking=True`` on a copy stream
  of their own, while the previous batch's compute runs
  (``training/pipeline.HostTierTrainer``).  The compute stream waits on the
  copy's event before :func:`assemble_features` reads the rows; a slab is
  rewritten only after its last copy has left; the copied tensors are
  recorded on the compute stream, so the caching allocator never hands
  their memory to another stream while compute still reads it.
* With host-resident structure (:class:`HostCSCStore`) each hop stages
  its miss rows' adjacency (and weights) as a compact sub-CSC; hot rows
  and staged rows are sampled on the card (:func:`sample_staged_hop`: K6,
  or on a weighted graph K8 on the hot rows and K7 on the staged ones).

The staged rows and the staged adjacency are compact: exactly the miss
rows, where the JAX package pads both to static shapes (a slab grown in
powers of two past ``miss_budget`` with pad slot L, a dense [M, deg_cap]
window).  The pinned slab grows in those powers of two (``width``), so a
batch a little larger than the last reuses it; only its first ``count``
rows are gathered and copied.  The counters mean the same and the
assembled features, ids and mask are the same.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph, HostGraph, _min_indptr_dtype
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.ops.hashtable import np_in_sorted
from dist_gnn_tpu_torch.ops.sampling import SampledNeighbors, sample_biased, sample_neighbors, sample_uniform
from dist_gnn_tpu_torch.utils import native
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device
from dist_gnn_tpu_torch.utils.staging import PinnedRing


@dataclasses.dataclass(frozen=True)
class HotTier:
    """Device-resident hot rows and their routing table."""

    sorted_ids: torch.Tensor  # [C] int32 strictly increasing
    rows: torch.Tensor  # [C, F]


class StagedRows(NamedTuple):
    """One batch's staged miss rows: device tensors and host bookkeeping."""

    rows: torch.Tensor  # [count, F] feature rows
    slots: torch.Tensor  # [count] int64 positions in the frontier
    count: int  # staged miss rows
    overflow: int  # misses beyond miss_budget (staged all the same)
    probe_s: float  # host seconds of the hot-tier probe (np_in_sorted)
    gather_s: float  # host seconds of the native gather
    # CUDA events around the host → device copy on the copy stream (None
    # on the CPU, where the rows are in place when stage returns)
    copy: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]
    width: int = 0  # rows of the pinned slab: miss_budget grown in powers of two past count

    def wait(self) -> None:
        """Make the current stream wait until the rows have arrived."""
        if self.copy is not None:
            torch.cuda.current_stream(self.rows.device).wait_event(self.copy[1])

    def h2d_ms(self) -> Optional[float]:
        return copy_ms(self.copy)


def copy_ms(copy: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]) -> Optional[float]:
    """Milliseconds between a stage's two copy events (waits for the
    second): the rows' and the slots' copies; None on the CPU."""
    if copy is None:
        return None
    copy[1].synchronize()
    return copy[0].elapsed_time(copy[1])


def slab_width(miss_budget: int, count: int, num_slots: int) -> int:
    """The staged slab's rows: ``miss_budget`` (at least 1) doubled until it
    holds ``count``, at most ``num_slots`` (the frontier's length, which
    holds every miss): the JAX package's lossless growth
    (``dist_gnn_tpu/parallel/host_dist.py:185-188``)."""
    w = max(int(miss_budget), 1)
    while w < count:
        w *= 2
    return min(w, num_slots) if num_slots else w


def _sorted_ids(cache_nids) -> np.ndarray:
    ids = np.unique(np.asarray(cache_nids, dtype=np.int32))
    return ids[ids != INVALID_ID]


def _hit_rate(sorted_ids: np.ndarray, nids) -> float:
    """Share of ``nids`` in the hot set (0 for an empty one)."""
    return float(np.mean(np_in_sorted(sorted_ids, nids)[0])) if len(sorted_ids) else 0.0


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


class HostFeatureStore:
    """Features host-resident; hot rows on the device; misses staged per
    batch.

    ``host_features`` is the full [N, F] matrix in host memory (numpy or
    ``np.memmap``, C-contiguous).  ``cache_nids`` are the hot ids from the
    heat/value policy (INVALID padding dropped).  ``miss_budget`` is the
    configured per-batch miss capacity: every miss is staged all the same,
    and ``overflow`` counts the rows beyond the budget.  ``hot_dtype`` (a torch float dtype) casts the hot rows;
    integer dtypes raise."""

    def __init__(
        self,
        host_features: np.ndarray,
        cache_nids: np.ndarray,
        miss_budget: int,
        hot_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if hot_dtype is not None and not hot_dtype.is_floating_point:
            raise ValueError(f"hot_dtype {hot_dtype} is a raw cast and must be a float dtype")
        self.base = host_features  # never uploaded whole
        cache_sorted = _sorted_ids(cache_nids)
        if cache_sorted.size and cache_sorted[-1] >= host_features.shape[0]:
            raise ValueError(f"hot ids outside the {host_features.shape[0]} feature rows")
        self.sorted_np = cache_sorted
        hot = torch.from_numpy(native.gather_rows(host_features, cache_sorted))
        if hot_dtype is not None:
            hot = hot.to(hot_dtype)
        self.hot_tier = HotTier(
            sorted_ids=torch.from_numpy(cache_sorted).to(self.device), rows=hot.to(self.device)
        )
        self.miss_budget = int(miss_budget)
        self._dtype = _torch_dtype(host_features.dtype)
        self._ring = PinnedRing(self.device)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    @property
    def feature_dim(self) -> int:
        return int(self.base.shape[1])

    def hit_rate(self, nids: np.ndarray) -> float:
        return _hit_rate(self.sorted_np, nids)

    def stage(self, frontier_np: np.ndarray, fmask_np: np.ndarray) -> StagedRows:
        """Host side: find this frontier's hot-tier misses, gather their
        rows from the host base into a pinned slab and start the copy to
        the device.  Returns at once; call while the device computes the
        previous batch."""
        return self._stage(self.sorted_np, frontier_np, fmask_np)

    def _stage(self, table: np.ndarray, frontier_np: np.ndarray, fmask_np: np.ndarray) -> StagedRows:
        """Stage the masked frontier slots whose ids ``table`` (sorted) does
        not hold."""
        t0 = time.perf_counter()
        member, _ = np_in_sorted(table, frontier_np)
        miss_idx = np.flatnonzero(fmask_np & ~member)
        probe_s = time.perf_counter() - t0
        m = len(miss_idx)
        overflow = max(0, m - self.miss_budget)
        width = slab_width(self.miss_budget, m, len(frontier_np))
        i = self._ring.acquire()
        rows_h = self._ring.buffer(i, "rows", (width, self.feature_dim), self._dtype)[:m]
        slots_h = self._ring.buffer(i, "slots", (width,), torch.int64)[:m]
        t0 = time.perf_counter()
        if m:
            native.gather_rows(self.base, frontier_np[miss_idx], out=rows_h.numpy())
        gather_s = time.perf_counter() - t0
        slots_h.copy_(torch.from_numpy(miss_idx))
        if self._copy_stream is None:
            return StagedRows(rows_h.clone(), slots_h.clone(), m, overflow, probe_s, gather_s, None, width)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rows = rows_h.to(self.device, non_blocking=True)
            slots = slots_h.to(self.device, non_blocking=True)
            end.record()
        self._ring.release(i, self._copy_stream)
        rows.record_stream(compute)
        slots.record_stream(compute)
        return StagedRows(rows, slots, m, overflow, probe_s, gather_s, (start, end), width)


def assemble_features(
    hot: HotTier,
    frontier: torch.Tensor,  # [L] int32
    fmask: torch.Tensor,  # [L] bool
    staged_rows: torch.Tensor,  # [m, F]
    staged_slots: torch.Tensor,  # [m] int64 positions in the frontier
) -> torch.Tensor:
    """Device side: the frontier's feature rows [L, F].  Hot rows come from
    a K1 gather of ``hot.rows`` at the positions a binary search of
    ``hot.sorted_ids`` finds (zero where no hot id matches), and staged
    rows are scattered to their slots.  Nothing is read back to the host."""
    C = hot.sorted_ids.shape[0]
    if C == 0:
        out = torch.zeros((frontier.shape[0], staged_rows.shape[1]), dtype=staged_rows.dtype,
                          device=frontier.device)
    else:
        pos = torch.clamp(torch.searchsorted(hot.sorted_ids, frontier), max=C - 1)
        hit = fmask & (hot.sorted_ids[pos] == frontier)
        out = gather_rows(hot.rows, pos.to(torch.int32))  # K1
        out.masked_fill_(~hit[:, None], 0)
    return out.index_copy_(0, staged_slots, staged_rows.to(out.dtype))


class StagedAdjacency(NamedTuple):
    """One hop's staged miss rows, on the device."""

    graph: Graph  # compact sub-CSC: row i = staged row i's neighbours and weights (hub rows empty)
    row_of: torch.Tensor  # [m] int64 position of each staged row in the seeds
    pre_ids: torch.Tensor  # [m, k] int32 host-presampled ids of hub rows
    pre_mask: torch.Tensor  # [m, k] bool
    is_pre: torch.Tensor  # [m] bool — True: take pre_ids
    count: int  # staged rows
    # misses beyond miss_budget: dropped (their rows sample nothing) by
    # HostCSCStore; staged all the same by DistHostCSCStore, which re-plans
    overflow: int
    presample_s: float = 0.0  # host seconds of the hub rows' presampling
    remote: int = 0  # staged rows of another rank's node range (DistHostCSCStore)


def _csc_graph(indptr: np.ndarray, indices: np.ndarray, device: torch.device, probs=None,
               with_alias: bool = False) -> Graph:
    """A device :class:`Graph` of a host sub-CSC (int32 ``indptr`` below
    2**31 edges), with its weights and, on request, their alias tables."""
    indptr = indptr.astype(_min_indptr_dtype(len(indices)))
    return HostGraph(indptr=indptr, indices=indices, probs=probs).to_device(device, with_alias=with_alias)


def plan_hop_arrays(
    indptr64: np.ndarray,  # [N+1] host CSC offsets
    indices: np.ndarray,  # [nnz] host CSC neighbour ids
    sorted_hot: np.ndarray,  # [C] sorted hot node ids
    miss_budget: int,
    deg_cap: int,
    seeds_np: np.ndarray,  # [L]
    mask_np: np.ndarray,  # [L]
    k: int,
    rng: np.random.Generator,
    probs: Optional[np.ndarray] = None,  # [nnz] per-edge weights (weighted graphs)
):
    """Host-side hop planning: probe the hot tier, stage the miss rows.

    Misses beyond ``miss_budget`` are dropped and counted.  A staged row of
    degree <= ``deg_cap`` ships its neighbour list (and, with ``probs``,
    its weights) in a compact sub-CSC, and the device draws k of them; a
    hub row (degree > ``deg_cap``) is presampled here in row order and
    ships its k picks: ``rng.choice(d, min(k, d), replace=False)``, or on a
    weighted graph the top k of the explicit Gumbel keys
    ``log(rng.random(d)) / max(w, 1e-38)`` (zero weights at -inf, never
    taken), the JAX package's ``rng`` calls in its order
    (``host_tier.py:252-262``), so the picks are its picks.

    Returns ``(local_rows [L] int32 — hot slot per seed or INVALID, dict of
    numpy arrays (indptr [m+1] int64, indices int32, probs f32 or None,
    row_of [m] int64, pre_ids [m, k], pre_mask [m, k], is_pre [m]) and the
    hub presampling's host seconds (``presample_s``), staged count,
    overflow)``."""
    safe_seed = np.where(mask_np, seeds_np, 0)
    member, pos = np_in_sorted(sorted_hot, safe_seed)
    hit = mask_np & member
    local_rows = np.where(hit, pos, INVALID_ID).astype(np.int32)

    miss_idx = np.flatnonzero(mask_np & ~hit)
    overflow = max(0, len(miss_idx) - miss_budget)
    miss_idx = miss_idx[:miss_budget]
    m = len(miss_idx)
    ids = seeds_np[miss_idx].astype(np.int64)
    start = indptr64[ids]
    deg = indptr64[ids + 1] - start
    small = deg <= deg_cap
    sub_indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.where(small, deg, 0), out=sub_indptr[1:])
    _, sub_indices, sub_probs = native.extract_subcsc(ids[small], indptr64, indices, probs)
    pre_ids = np.full((m, k), INVALID_ID, np.int32)
    pre_mask = np.zeros((m, k), bool)
    is_pre = ~small
    t0 = time.perf_counter()
    for j in np.flatnonzero(is_pre):
        d = int(deg[j])
        if probs is not None:
            w = np.asarray(probs[start[j] : start[j] + d], np.float64)
            keys = np.where(w > 0, np.log(rng.random(d)) / np.maximum(w, 1e-38), -np.inf)
            picks = np.argsort(-keys)[: min(k, d)]
            picks = picks[keys[picks] > -np.inf]
        else:
            picks = rng.choice(d, size=min(k, d), replace=False)
        row = np.asarray(indices[start[j] : start[j] + d])[picks]
        pre_ids[j, : len(row)] = row
        pre_mask[j, : len(row)] = True
    presample_s = time.perf_counter() - t0
    arrs = dict(
        indptr=sub_indptr, indices=sub_indices, probs=sub_probs, row_of=miss_idx.astype(np.int64),
        pre_ids=pre_ids, pre_mask=pre_mask, is_pre=is_pre, presample_s=presample_s,
    )
    return local_rows, arrs, m, overflow


class HostCSCStore:
    """Graph structure host-resident; hot sub-CSC on the device; per-hop
    staging of the miss rows' adjacency.

    Sampling a hop probes the hot table on the host (the seeds are on the
    host between hops anyway); hot rows sample from the device sub-CSC,
    miss rows from their staged adjacency (:func:`plan_hop_arrays`), both
    on the card (K6; on a weighted graph K8 from the hot rows' own alias
    tables and K7 on the staged rows) — the reference's per-row
    local/peer/host routing (``rowwise_sampling_p2p.cu:180-223``) with the
    host tier made explicit."""

    def __init__(self, hg, cache_nids: np.ndarray, miss_budget: int, deg_cap: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.hg = hg
        self.indptr64 = np.asarray(hg.indptr, dtype=np.int64)
        self.miss_budget = int(miss_budget)
        self.deg_cap = int(deg_cap)
        self.sorted_np = _sorted_ids(cache_nids)
        sp, si, spr = native.extract_subcsc(self.sorted_np, self.indptr64, hg.indices, hg.probs)
        # a weighted hot sub-CSC carries its weights and alias tables, so its
        # rows take the alias sampler (JAX: host_tier.py:316-338)
        self.hot_graph = _csc_graph(sp, si, self.device, spr, with_alias=len(si) > 0)

    def hit_rate(self, nids: np.ndarray) -> float:
        return _hit_rate(self.sorted_np, nids)

    def plan_hop(self, seeds_np: np.ndarray, mask_np: np.ndarray, k: int, rng: np.random.Generator):
        """Host side: probe the hot tier and stage the miss rows' adjacency.
        Returns ``(local_rows_np [L], StagedAdjacency)``; ``rng`` draws the
        hub rows' picks."""
        local_rows, a, m, overflow = self._plan(seeds_np, mask_np, k, rng, self.miss_budget)
        return local_rows, self._staged(a, m, overflow)

    def _plan(self, seeds_np, mask_np, k: int, rng, budget: int):
        return plan_hop_arrays(
            self.indptr64, self.hg.indices, self.sorted_np, budget, self.deg_cap,
            seeds_np, mask_np, k, rng, probs=self.hg.probs,
        )

    def _staged(self, a: dict, m: int, overflow: int, remote: int = 0) -> StagedAdjacency:
        """:func:`plan_hop_arrays`' numpy arrays on the device."""
        dev = self.device
        return StagedAdjacency(
            graph=_csc_graph(a["indptr"], a["indices"], dev, a["probs"]),
            row_of=torch.from_numpy(a["row_of"]).to(dev),
            pre_ids=torch.from_numpy(a["pre_ids"]).to(dev),
            pre_mask=torch.from_numpy(a["pre_mask"]).to(dev),
            is_pre=torch.from_numpy(a["is_pre"]).to(dev),
            count=m,
            overflow=overflow,
            presample_s=a["presample_s"],
            remote=remote,
        )


def sample_staged_hop(
    hot_graph: Graph,
    local_rows: torch.Tensor,  # [L] int32 hot slots (INVALID on a miss)
    staged: StagedAdjacency,
    k: int,
    key,
) -> SampledNeighbors:
    """One hop over the two tiers, [L, k] aligned with the hop's seeds.

    Hot rows draw k of their neighbours with the hot sub-CSC's sampler
    (``ops/sampling.sample_neighbors``: K6, or K8 on a weighted graph's hot
    rows, as the JAX package's hot tier dispatches), staged rows on the
    staged sub-CSC (seeds 0..m-1) with K6 — all of a row of degree <= k,
    else a keyed Feistel permutation's first k — or, weighted, with K7 —
    the Gumbel top-k of ``mix32(row_key ^ mix32(col))`` over the whole row.
    Each is the JAX package's staged-window draw (``host_tier.py:374-404``)
    on the compact rows.  Hub rows take their host picks; staged results
    are scattered to their seed positions.

    ``key`` is a ``torch.Generator`` that draws the hot rows' keys then the
    staged rows' [m], or the pair (hot keys, staged keys) itself, of which
    the staged rows take the first m.  JAX's are
    ``prng.random_keys(key, (L,))`` on an unweighted graph, on a weighted
    one the alias sampler's (``ops/sampling.alias_keys``), and for the
    first m staged rows ``prng.random_keys(fold_in(key, 1), (M,))``."""
    hot_key, staged_key = (key, key) if isinstance(key, torch.Generator) else (key[0], key[1][: staged.count])
    nb = sample_neighbors(hot_graph, local_rows, k, False, hot_key)  # K6 or K8
    seeds_m = torch.arange(staged.count, dtype=torch.int32, device=local_rows.device)
    staged_sampler = sample_uniform if staged.graph.probs is None else sample_biased  # K6 or K7
    nb_m = staged_sampler(staged.graph, seeds_m, k, False, staged_key)
    pre = staged.is_pre[:, None]
    mask_m = torch.where(pre, staged.pre_mask, nb_m.mask)
    ids_m = torch.where(mask_m, torch.where(pre, staged.pre_ids, nb_m.ids), INVALID_ID)
    ids, mask = nb.ids, nb.mask
    ids.index_copy_(0, staged.row_of, ids_m)
    mask.index_copy_(0, staged.row_of, mask_m)
    return SampledNeighbors(ids=ids, mask=mask, overflow=nb.overflow)
