"""End-to-end cache construction: heat → policy → hot id sets.

Counterpart of ``dist_gnn_tpu/cache/builder.py``: the orchestration the
reference spreads over its trainer set-up (``node_classification.py:
86-199``: get_node_heat → selfish/selfless/auto policy → cache ctors) as
one call producing the INVALID-padded hot id matrices that the stores
(``host_tier.HostCSCStore``, ``host_tier.HostFeatureStore``,
``feature_server.CachedFeatureStore``) take.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.cache.cost_model import CostModel
from dist_gnn_tpu_torch.cache.policy import (
    get_cache_nids_auto,
    get_cache_nids_selfish,
    get_cache_nids_selfless,
)
from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
from dist_gnn_tpu_torch.ops.heat import get_node_heat_all, get_node_heat_all_host
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def compute_heats(
    hg: HostGraph,
    train_parts: Sequence[np.ndarray],
    fan_out: Sequence[int],
    device_budget_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device sampling/feature heats, [D, N] each, each device's heat
    propagated from its own train-seed partition (``node_classification.py:
    57``), all D in one streamed edge sweep per hop, on ``device`` (default:
    the card).

    When the CSC plus the [D, N] accumulators would exceed
    ``device_budget_bytes``, the graph is never uploaded: edges stream from
    host memory and the accumulators are grouped
    (:func:`~dist_gnn_tpu_torch.ops.heat.get_node_heat_all_host`)."""
    dev = resolve_device(device)
    D, N = len(train_parts), hg.num_nodes
    seeds = np.zeros((D, N), np.float32)
    for d, part in enumerate(train_parts):
        seeds[d, np.asarray(part)] = 1.0
    if device_budget_bytes is not None:
        struct_bytes = (
            np.asarray(hg.indptr).nbytes
            + np.asarray(hg.indices).nbytes
            + (np.asarray(hg.probs).nbytes if hg.probs is not None else 0)
        )
        if struct_bytes + 4 * D * N * 4 > device_budget_bytes:
            return get_node_heat_all_host(
                hg, seeds, list(fan_out), device_budget_bytes=device_budget_bytes, device=dev
            )
    s, f = get_node_heat_all(hg.to_device(dev), torch.from_numpy(seeds).to(dev), list(fan_out))
    return s.cpu().numpy(), f.cpu().numpy()


def _pad_plans(plans, pad_to: Optional[int] = None) -> np.ndarray:
    """[(nids per device)] → [D, C] INVALID-padded matrix."""
    C = max(pad_to or max((len(p) for p in plans), default=1), 1)
    out = np.full((len(plans), C), INVALID_ID, np.int32)
    for d, p in enumerate(plans):
        out[d, : min(len(p), C)] = p[:C]
    return out


def build_cache_plan(
    hg: HostGraph,
    feature_dim: int,
    train_parts: Sequence[np.ndarray],
    fan_out: Sequence[int],
    capacity_bytes: int,
    policy: str = "auto",
    cost: Optional[CostModel] = None,
    device_budget_bytes: Optional[int] = None,
    hot_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
):
    """Returns (mode, structure_hot_ids [D, Cs], feature_hot_ids [D, Cf]).

    ``capacity_bytes`` is the per-device budget for both hot tiers
    together (``node_classification.py:73,170``); ``device_budget_bytes``
    caps the memory of the heat pass (see :func:`compute_heats`).
    ``hot_dtype`` sets the bytes of a cached feature row: None or f32 4F, a
    narrower float dtype its size times F, ``torch.int8`` the ``F + 4``
    bytes of a packed row (``ops/quantize.py``), as the JAX package's
    ``hot_dtype='int8'`` (builder.py:102-110)."""
    if hot_dtype is not None and not (hot_dtype.is_floating_point or hot_dtype == torch.int8):
        raise ValueError(f"hot_dtype {hot_dtype} is neither a float dtype nor torch.int8")
    cost = cost or CostModel()
    s_heats, f_heats = compute_heats(
        hg, train_parts, fan_out, device_budget_bytes=device_budget_bytes, device=device
    )
    if hot_dtype == torch.int8:
        frb = feature_dim + 4
    else:
        frb = None if hot_dtype in (None, torch.float32) else hot_dtype.itemsize * feature_dim
    args = (hg, feature_dim, s_heats, f_heats, capacity_bytes, cost, frb)
    if policy == "selfish":
        mode, plans = "selfish", get_cache_nids_selfish(*args)
    elif policy == "selfless":
        mode, plans = "selfless", get_cache_nids_selfless(*args)
    else:
        mode, plans = get_cache_nids_auto(*args)
    return mode, _pad_plans([p[0] for p in plans]), _pad_plans([p[1] for p in plans])
