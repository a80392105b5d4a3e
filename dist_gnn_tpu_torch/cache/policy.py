"""Heat/value cache-admission policy (selfish / selfless / auto).

Counterpart of ``dist_gnn_tpu/cache/policy.py``, which ports the logic of
the reference's ``cache_value.py``; host-side numpy, run once at set-up,
over ``[num_devices, num_nodes]`` heat matrices:

* value = heat / space_bytes * reduced_time (``cache_value.py:176-179``);
* greedy knapsack: structure and feature candidates together, sorted by
  value, cut at the capacity (``get_cache_nids_local`` :183-206);
* selfish = each device independently over its own heat (:210-240);
* selfless = each hot node owned by the device where it is hottest, the
  leftover capacity refilled selfishly, ordered by heat (:244-310);
* auto = score both with the total-value models (:313-409) and keep the
  better; the selfless score discounts local bandwidth by peer traffic.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from dist_gnn_tpu_torch.cache.cost_model import CostModel
from dist_gnn_tpu_torch.graph import HostGraph


def structure_space_bytes(graph: HostGraph, nids: np.ndarray) -> np.ndarray:
    """Bytes to cache each node's structure row (``cache_value.py:153-165``)."""
    deg = (graph.indptr[nids + 1] - graph.indptr[nids]).astype(np.int64)
    per_edge = graph.indices.itemsize + (
        graph.probs.itemsize if graph.probs is not None else 0
    )
    return deg * per_edge + graph.indptr.itemsize


def feature_space_bytes(feature_dim: int, itemsize: int = 4) -> int:
    return feature_dim * itemsize


def _knapsack(
    s_nids: np.ndarray,
    s_space: np.ndarray,
    s_value: np.ndarray,
    f_nids: np.ndarray,
    f_space: np.ndarray,
    f_value: np.ndarray,
    capacity_bytes: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy joint knapsack over structure+feature candidates
    (``get_cache_nids_local``, ``cache_value.py:183-206``)."""
    all_value = np.concatenate([s_value, f_value])
    order = np.argsort(-all_value, kind="stable")
    sizes = np.concatenate([s_space, f_space])[order]
    prefix = np.cumsum(sizes)
    cut = int(np.searchsorted(prefix, capacity_bytes, side="right"))
    chosen = order[:cut]
    used = int(prefix[cut - 1]) if cut > 0 else 0
    is_struct = chosen < len(s_nids)
    return s_nids[chosen[is_struct]], f_nids[chosen[~is_struct] - len(s_nids)], used


def _selfish_one(
    graph: HostGraph,
    feature_dim: int,
    sampling_heat: np.ndarray,
    feature_heat: np.ndarray,
    capacity_bytes: int,
    cost: CostModel,
    feature_row_bytes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    s_hot = np.flatnonzero(sampling_heat)
    f_hot = np.flatnonzero(feature_heat)
    s_space = structure_space_bytes(graph, s_hot)
    f_sz = feature_row_bytes or feature_space_bytes(feature_dim)
    s_value = sampling_heat[s_hot] / s_space * cost.sampling_reduced_time()
    f_value = feature_heat[f_hot] / f_sz * cost.feature_reduced_time()
    f_space = np.full(len(f_hot), f_sz, dtype=np.int64)
    return _knapsack(s_hot, s_space, s_value, f_hot, f_space, f_value, capacity_bytes)


def get_cache_nids_selfish(
    graph: HostGraph,
    feature_dim: int,
    sampling_heats: np.ndarray,  # [D, N]
    feature_heats: np.ndarray,  # [D, N]
    capacity_bytes: int,
    cost: Optional[CostModel] = None,
    feature_row_bytes: Optional[int] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-device independent admission; returns [(structure_nids,
    feature_nids)] per device.

    ``feature_row_bytes`` overrides the f32 per-row cost of a feature row
    (``2 * feature_dim`` for a bf16 hot tier), so that the knapsack counts
    the rows a byte of a narrower tier holds."""
    cost = cost or CostModel()
    out = []
    for d in range(sampling_heats.shape[0]):
        s, f, _ = _selfish_one(
            graph, feature_dim, sampling_heats[d], feature_heats[d],
            capacity_bytes, cost, feature_row_bytes,
        )
        out.append((s, f))
    return out


def get_cache_nids_selfless(
    graph: HostGraph,
    feature_dim: int,
    sampling_heats: np.ndarray,
    feature_heats: np.ndarray,
    capacity_bytes: int,
    cost: Optional[CostModel] = None,
    feature_row_bytes: Optional[int] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Deduplicated admission: each hot node is admitted only on the device
    where it is hottest; leftover capacity refilled selfishly."""
    cost = cost or CostModel()
    D, N = sampling_heats.shape
    s_owner = np.argmax(sampling_heats, axis=0)
    f_owner = np.argmax(feature_heats, axis=0)
    out = []
    for d in range(D):
        s_heat_d = sampling_heats[d]
        f_heat_d = feature_heats[d]
        s_owned = np.flatnonzero((s_owner == d) & (s_heat_d > 0))
        f_owned = np.flatnonzero((f_owner == d) & (f_heat_d > 0))

        s_space = structure_space_bytes(graph, s_owned)
        f_sz = feature_row_bytes or feature_space_bytes(feature_dim)
        s_value = s_heat_d[s_owned] / s_space * cost.sampling_reduced_time()
        f_value = f_heat_d[f_owned] / f_sz * cost.feature_reduced_time()
        f_space = np.full(len(f_owned), f_sz, dtype=np.int64)
        s_nids, f_nids, used = _knapsack(
            s_owned, s_space, s_value, f_owned, f_space, f_value, capacity_bytes
        )

        if capacity_bytes - used > 0:
            # refill: selfish pass over everything not already cached here
            s_heat_masked = s_heat_d.copy()
            f_heat_masked = f_heat_d.copy()
            s_heat_masked[s_nids] = 0
            f_heat_masked[f_nids] = 0
            s_extra, f_extra, _ = _selfish_one(
                graph,
                feature_dim,
                s_heat_masked,
                f_heat_masked,
                capacity_bytes - used,
                cost,
                feature_row_bytes,
            )
            s_nids = np.concatenate([s_nids, s_extra])
            f_nids = np.concatenate([f_nids, f_extra])

        # order by heat desc (``cache_value.py:305-308``)
        s_nids = s_nids[np.argsort(-s_heat_d[s_nids], kind="stable")]
        f_nids = f_nids[np.argsort(-f_heat_d[f_nids], kind="stable")]
        out.append((s_nids, f_nids))
    return out


def _total_value(
    graph, feature_dim, s_heat, f_heat, s_nids, f_nids, bw_fast, cost,
    feature_row_bytes=None,
) -> float:
    """``compute_total_value_selfish`` (``cache_value.py:314-343``) with a
    parameterisable fast-tier bandwidth."""
    s_rt = (
        cost.sampling_read_bytes_slow / cost.bandwidth_host
        - cost.sampling_read_bytes_fast / bw_fast
    )
    f_rt = (
        cost.feature_read_bytes_slow / cost.bandwidth_host
        - cost.feature_read_bytes_fast / bw_fast
    )
    s_space = structure_space_bytes(graph, s_nids)
    f_sz = feature_row_bytes or feature_space_bytes(feature_dim)
    v = float(np.sum(s_heat[s_nids] / np.maximum(s_space, 1) * s_rt))
    v += float(np.sum(f_heat[f_nids] / f_sz * f_rt))
    return v


def score_selfish(graph, feature_dim, heats, plans, cost, feature_row_bytes=None) -> float:
    sampling_heats, feature_heats = heats
    return sum(
        _total_value(
            graph, feature_dim, sampling_heats[d], feature_heats[d],
            plans[d][0], plans[d][1], cost.bandwidth_hbm, cost,
            feature_row_bytes,
        )
        for d in range(len(plans))
    )


def score_selfless(
    graph, feature_dim, heats, plans, cost, feature_row_bytes=None
) -> float:
    """``compute_total_value_selfless`` (``cache_value.py:347-409``): local
    hits at contended local bandwidth + peer hits at peer bandwidth."""
    sampling_heats, feature_heats = heats
    D = len(plans)
    bw_local = cost.local_bandwidth_selfless(D)
    total = 0.0
    N = graph.num_nodes
    s_counts = np.zeros(N, np.int32)
    f_counts = np.zeros(N, np.int32)
    for s_nids, f_nids in plans:
        s_counts[s_nids] += 1
        f_counts[f_nids] += 1
    for d in range(D):
        s_nids, f_nids = plans[d]
        total += _total_value(
            graph, feature_dim, sampling_heats[d], feature_heats[d],
            s_nids, f_nids, bw_local, cost, feature_row_bytes,
        )
        s_mask = s_counts > 0
        f_mask = f_counts > 0
        s_mask[s_nids] = False
        f_mask[f_nids] = False
        total += _total_value(
            graph, feature_dim, sampling_heats[d], feature_heats[d],
            np.flatnonzero(s_mask), np.flatnonzero(f_mask),
            cost.bandwidth_ici, cost, feature_row_bytes,
        )
        # (no restore needed: s_mask/f_mask are rebuilt from the counts
        # at the top of each iteration)
    return total


def get_cache_nids_auto(
    graph: HostGraph,
    feature_dim: int,
    sampling_heats: np.ndarray,
    feature_heats: np.ndarray,
    capacity_bytes: int,
    cost: Optional[CostModel] = None,
    feature_row_bytes: Optional[int] = None,
) -> Tuple[str, List[Tuple[np.ndarray, np.ndarray]]]:
    """Score selfish vs selfless plans, return ('selfish'|'selfless', plans)."""
    cost = cost or CostModel()
    heats = (sampling_heats, feature_heats)
    selfish = get_cache_nids_selfish(
        graph, feature_dim, sampling_heats, feature_heats, capacity_bytes,
        cost, feature_row_bytes,
    )
    selfless = get_cache_nids_selfless(
        graph, feature_dim, sampling_heats, feature_heats, capacity_bytes,
        cost, feature_row_bytes,
    )
    v_selfish = score_selfish(
        graph, feature_dim, heats, selfish, cost, feature_row_bytes
    )
    v_selfless = score_selfless(
        graph, feature_dim, heats, selfless, cost, feature_row_bytes
    )
    if v_selfless > v_selfish:
        return "selfless", selfless
    return "selfish", selfish
