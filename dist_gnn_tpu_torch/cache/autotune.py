"""Frontier caps and the distributed host tiers' knobs from the graph: the
caps half of the JAX package's sampler tuner
(``dist_gnn_tpu/cache/autotune.py:41-251``) and its ``tune_dist_tier``
(``:449-565``).

A one-time host pass simulates a few mini-batches with a numpy sampler
(exact frontier semantics: per-hop distinct-neighbour draws, dedup with
seeds-first capacity accounting, a dedup-free final hop) and sizes each
hop's frontier cap from the observed maximum times a slack, rounded up to
512.  The caps are lossless for batches like the simulated ones; the
runtime ``frontier_overflow`` counter guards against distribution shift.

Numpy only, copied as it is, so the caps and the dist-tier knobs equal the
JAX package's for the same graph, batch, fanout and seed.  The JAX tuner's
window and budget knobs (``window``, ``big_row_budget``),
``SamplerCostModel`` and ``tune_sampler_cost`` price TPU gather layouts the
port does not have and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from dist_gnn_tpu_torch.graph import INVALID_ID
from dist_gnn_tpu_torch.ops.hashtable import np_in_sorted


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """The tuned sampler knobs: ``frontier_caps`` for ``sample_blocks``,
    ``NeighborSampler`` and ``Trainer`` (the JAX config's window and budget
    fields are TPU layouts, not ported)."""

    frontier_caps: Tuple[int, ...]  # sampling order (deepest hop last)


def _round_up(x: int, m: int) -> int:
    return int(-(-int(x) // m) * m)


def _pow2_at_least(x: int, lo: int = 32, hi: int = 4096) -> int:
    w = lo
    while w < min(x, hi):
        w *= 2
    return w


def _simulate_hops(
    indptr: np.ndarray,
    indices: np.ndarray,
    train_idx: np.ndarray,
    batch_size: int,
    fan_out: Sequence[int],
    trials: int,
    seed: int,
):
    """Numpy mini-batch simulation mirroring the sampler's frontier
    accounting.  Returns ``(caps_seen, trails)``: the relabelled frontier
    sizes seen per hop (sampling order), and per trial the seed array of
    every hop with the final hop's frontier slots (``[seeds; neighbours]``
    with duplicates, the dedup-free hop's layout), drawn with the JAX
    function's ``rng`` calls in its order, so they equal its first and
    third outputs (its second, the window tuner's degree samples, is not
    ported)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    deg_all = np.diff(indptr).astype(np.int64)
    rng = np.random.default_rng(seed)
    fan_rev = list(reversed(list(fan_out)))

    caps_seen = [[] for _ in fan_rev]
    trails = []

    for _ in range(trials):
        seeds = rng.choice(train_idx, size=min(batch_size, len(train_idx)), replace=False)
        trail_seeds = []
        trails.append((trail_seeds, None))
        for i, k in enumerate(fan_rev):
            trail_seeds.append(seeds.copy())
            deg = deg_all[seeds]
            take = np.minimum(deg, k)  # distinct draws per row
            total = int(take.sum())
            row_rep = np.repeat(np.arange(len(seeds)), take)
            offs = np.empty(total, np.int64)
            pos = 0
            for d, tk in zip(deg, take):
                if tk == 0:
                    continue
                if d <= k:
                    offs[pos : pos + tk] = np.arange(tk)
                else:
                    offs[pos : pos + tk] = rng.choice(d, size=tk, replace=False)
                pos += tk
            starts = indptr[seeds].astype(np.int64)
            from_nodes = indices[starts[row_rep] + offs]
            if i == len(fan_rev) - 1:  # the dedup-free final hop sets no cap
                trails[-1] = (trail_seeds, np.concatenate([seeds, from_nodes]))
                break
            new_front = np.unique(np.concatenate([seeds, from_nodes]))
            caps_seen[i].append(len(new_front))
            seeds = new_front
    return caps_seen, trails


def _coverage_caps(caps_seen, fan_rev: Sequence[int], batch_size: int, cap_slack: float):
    """Frontier caps from the observed per-hop maxima: the worst seen times
    ``cap_slack`` rounded up to 512, never above the padded worst case; the
    dedup-free final hop keeps 10**9 (it is never relabelled)."""
    caps = []
    pad = batch_size
    for i, k in enumerate(fan_rev):
        pad = pad * (k + 1)
        if i == len(fan_rev) - 1:
            caps.append(10**9)
        else:
            worst = max(caps_seen[i])
            caps.append(min(_round_up(worst * cap_slack, 512), pad))
            pad = caps[-1]
    return caps


def tune_sampler(
    indptr: np.ndarray,
    indices: np.ndarray,
    train_idx: np.ndarray,
    batch_size: int,
    fan_out: Sequence[int],
    *,
    trials: int = 4,
    cap_slack: float = 1.05,
    seed: int = 0,
) -> SamplerConfig:
    """Frontier caps for ``sample_blocks``/``Trainer`` (sampling order)
    from ``trials`` simulated batches: the JAX package's
    ``tune_sampler(...).frontier_caps``, which its bench trains under (its
    ``tune_sampler_cost`` shares the same ``_coverage_caps``)."""
    caps_seen, _ = _simulate_hops(indptr, indices, train_idx, batch_size, fan_out, trials, seed)
    fan_rev = list(reversed(list(fan_out)))
    return SamplerConfig(frontier_caps=tuple(_coverage_caps(caps_seen, fan_rev, batch_size, cap_slack)))


def tune_sampler_for(hg, train_idx, batch_size, fan_out, **kw) -> SamplerConfig:
    """:func:`tune_sampler` bound to a ``HostGraph``."""
    return tune_sampler(
        np.asarray(hg.indptr), np.asarray(hg.indices), np.asarray(train_idx), batch_size, fan_out, **kw,
    )


@dataclasses.dataclass(frozen=True)
class DistTierConfig:
    """The distributed host tiers' knobs, from the batch simulation that
    tunes the sampler (``dist_gnn_tpu/cache/autotune.py:449-475``).

    * ``feat_miss_budget`` / ``struct_miss_budget``: per-rank per-batch
      staged-row capacities of ``DistHostFeatureStore`` /
      ``DistHostCSCStore``.  Both stage every miss past the budget (the
      feature slab grows, the hop re-plans), so the budget sizes the
      common case's transfer.
    * ``deg_cap``: the widest staged row shipped whole (the p95 missed-row
      degree); wider rows are presampled on the host.
    * ``exchange_slack``: per-peer request-budget slack of the base
      feature exchange (worst per-owner load over the even share).
    * ``peer_slack``: the same for the peer-hot tier's owner buckets.
    """

    feat_miss_budget: int
    struct_miss_budget: int
    deg_cap: int
    exchange_slack: float
    peer_slack: float


def tune_dist_tier(
    indptr: np.ndarray,
    indices: np.ndarray,
    train_idx: np.ndarray,
    batch_per_chip: int,
    fan_out: Sequence[int],
    n_chips: int,
    *,
    hot_ids: Optional[np.ndarray] = None,  # [n, C] per-rank plan (INVALID pad)
    num_nodes: Optional[int] = None,
    trials: int = 3,
    slack: float = 1.5,
    seed: int = 0,
) -> DistTierConfig:
    """The dist-tier knobs from per-rank batch simulations: each rank's
    seed shard is walked with :func:`_simulate_hops`, and the plan's hot
    tables are probed as ``stage`` and ``plan_hop`` probe them at run time
    (``dist_gnn_tpu/cache/autotune.py:478-565``, the same numpy calls in
    the same order, so the config equals the JAX package's)."""
    indptr = np.asarray(indptr)
    deg_all = np.diff(indptr).astype(np.int64)
    N = num_nodes if num_nodes is not None else len(indptr) - 1
    shard_size = -(-N // n_chips)
    parts = np.array_split(np.asarray(train_idx), n_chips)

    if hot_ids is not None:
        hot_sorted = [np.sort(hot_ids[c][hot_ids[c] != INVALID_ID]) for c in range(n_chips)]
        union_sorted = np.sort(np.unique(np.concatenate([h for h in hot_sorted] or [np.zeros(0)])))
    else:
        hot_sorted = [np.zeros(0, np.int64)] * n_chips
        union_sorted = np.zeros(0, np.int64)

    def _in(table, ids):
        return np_in_sorted(table, ids)[0]

    feat_miss_max = struct_miss_max = 0
    missed_degs = []
    owner_over = peer_over = 1.0
    for c in range(n_chips):
        if len(parts[c]) == 0:
            continue
        _, trails = _simulate_hops(indptr, indices, parts[c], batch_per_chip, fan_out, trials, seed + 17 * c)
        for trail_seeds, frontier in trails:
            # structure: each hop's seed rows not hot on THIS rank
            for seeds in trail_seeds:
                miss = ~_in(hot_sorted[c], seeds)
                struct_miss_max = max(struct_miss_max, int(miss.sum()))
                if miss.any():
                    missed_degs.append(deg_all[seeds[miss]])
            if frontier is None:
                continue
            # features: frontier slots hot on no rank (what stage ships)
            fmiss = ~_in(union_sorted, frontier)
            feat_miss_max = max(feat_miss_max, int(fmiss.sum()))
            # exchange skew: per-owner bucket load over the even share
            owners = np.clip(frontier // shard_size, 0, n_chips - 1)
            counts = np.bincount(owners, minlength=n_chips)
            share = max(1.0, len(frontier) / n_chips)
            owner_over = max(owner_over, counts.max() / share)
            # peer-hot skew: hot-somewhere ids routed to their caching rank
            hot_somewhere = _in(union_sorted, frontier)
            if hot_somewhere.any() and hot_ids is not None:
                hs = frontier[hot_somewhere]
                powner = np.zeros(len(hs), np.int64)
                for cc in range(n_chips):
                    powner[_in(hot_sorted[cc], hs)] = cc
                pc = np.bincount(powner, minlength=n_chips)
                peer_over = max(peer_over, pc.max() / max(1.0, len(hs) / n_chips))

    degs = np.concatenate(missed_degs) if missed_degs else np.zeros(1)
    deg_cap = int(np.clip(_pow2_at_least(int(np.percentile(degs, 95)) + 1, 32, 2048), 32, 2048))
    return DistTierConfig(
        feat_miss_budget=_round_up(max(256, feat_miss_max * slack), 256),
        struct_miss_budget=_round_up(max(256, struct_miss_max * slack), 256),
        deg_cap=deg_cap,
        exchange_slack=round(float(owner_over) * 1.1 + 0.05, 2),
        peer_slack=round(float(peer_over) * 1.1 + 0.05, 2),
    )
