"""Frontier caps from the graph: the caps half of the JAX package's sampler
tuner (``dist_gnn_tpu/cache/autotune.py:41-251``).

A one-time host pass simulates a few mini-batches with a numpy sampler
(exact frontier semantics: per-hop distinct-neighbour draws, dedup with
seeds-first capacity accounting, a dedup-free final hop) and sizes each
hop's frontier cap from the observed maximum times a slack, rounded up to
512.  The caps are lossless for batches like the simulated ones; the
runtime ``frontier_overflow`` counter guards against distribution shift.

Numpy only, copied as it is, so the caps equal the JAX package's for the
same graph, batch, fanout and seed.  The JAX tuner's window and budget
knobs (``window``, ``big_row_budget``), ``SamplerCostModel`` and
``tune_sampler_cost`` price TPU gather layouts the port does not have and
are not ported; ``tune_dist_tier`` comes with the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """The tuned sampler knobs: ``frontier_caps`` for ``sample_blocks``,
    ``NeighborSampler`` and ``Trainer`` (the JAX config's window and budget
    fields are TPU layouts, not ported)."""

    frontier_caps: Tuple[int, ...]  # sampling order (deepest hop last)


def _round_up(x: int, m: int) -> int:
    return int(-(-int(x) // m) * m)


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
    accounting.  Returns the relabelled frontier sizes seen per hop
    (sampling order), drawn with the JAX function's ``rng`` calls in its
    order, so they equal its first output."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    deg_all = np.diff(indptr).astype(np.int64)
    rng = np.random.default_rng(seed)
    fan_rev = list(reversed(list(fan_out)))

    caps_seen = [[] for _ in fan_rev]

    for _ in range(trials):
        seeds = rng.choice(train_idx, size=min(batch_size, len(train_idx)), replace=False)
        for i, k in enumerate(fan_rev):
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
            if i == len(fan_rev) - 1:  # the dedup-free final hop sets no cap
                break
            starts = indptr[seeds].astype(np.int64)
            from_nodes = indices[starts[row_rep] + offs]
            new_front = np.unique(np.concatenate([seeds, from_nodes]))
            caps_seen[i].append(len(new_front))
            seeds = new_front
    return caps_seen


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
    caps_seen = _simulate_hops(indptr, indices, train_idx, batch_size, fan_out, trials, seed)
    fan_rev = list(reversed(list(fan_out)))
    return SamplerConfig(frontier_caps=tuple(_coverage_caps(caps_seen, fan_rev, batch_size, cap_slack)))


def tune_sampler_for(hg, train_idx, batch_size, fan_out, **kw) -> SamplerConfig:
    """:func:`tune_sampler` bound to a ``HostGraph``."""
    return tune_sampler(
        np.asarray(hg.indptr), np.asarray(hg.indices), np.asarray(train_idx), batch_size, fan_out, **kw,
    )
