"""Rowwise uniform neighbour sampling with static padded shapes.

Counterpart of the uniform path of ``dist_gnn_tpu/ops/sampling.py``:

* without replacement, a keyed Feistel permutation of [0, degree) is
  evaluated at slots 0..k-1 (a row of degree <= k takes all of its
  neighbours);
* with replacement, k independent ``bits % degree`` draws.

Padded seeds (INVALID_ID) and zero-degree rows give fully masked rows;
masked slots hold INVALID_ID.  Only the JAX package's exact elementwise
fetch is ported (its window cascade is a TPU gather layout), so no draw
is ever dropped and ``overflow`` is always 0.

Randomness is a pure function of per-row uint32 keys: ``row_key[B]`` for
replace=False, ``bits[B, k]`` for replace=True.  ``key`` is either a
``torch.Generator`` the keys are drawn from, or the key tensor itself, so a
test can inject the JAX package's ``prng.random_keys`` and require the same
samples.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph
from dist_gnn_tpu_torch.ops import prng

Key = Union[torch.Generator, torch.Tensor]


class SampledNeighbors(NamedTuple):
    ids: torch.Tensor  # [B, k] int32 global neighbour ids, INVALID_ID padded
    mask: torch.Tensor  # [B, k] bool
    # sampled slots masked because a static budget was exceeded: always 0
    # on the exact paths the port has
    overflow: int = 0


def draw_keys(key: Key, shape, device: torch.device) -> torch.Tensor:
    """The uint32 keys of one sampling call: drawn from a generator, or the
    injected tensor itself (checked for shape)."""
    if isinstance(key, torch.Generator):
        return prng.random_keys(key, shape, device)
    key = torch.as_tensor(key)
    if tuple(key.shape) != tuple(shape):
        raise ValueError(f"injected keys have shape {tuple(key.shape)}, need {tuple(shape)}")
    return key.to(device=device, dtype=torch.int64)


def _row_extents(graph: Graph, seeds: torch.Tensor):
    valid = seeds != INVALID_ID
    safe = torch.where(valid, seeds, 0).long()
    start = graph.indptr[safe].long()
    deg = (graph.indptr[safe + 1].long() - start).to(torch.int32)
    deg = torch.where(valid, deg, 0)
    return start, deg, valid


def sample_uniform(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Uniformly sample up to ``k`` in-neighbours per seed row.

    Distinctness caveat (replace=False): picks come from a keyed Feistel
    permutation whose cycle-walk fallback breaks bijectivity with ~1e-3
    probability per element (``prng.feistel_permutation``), so a row can
    very rarely hold a duplicate neighbour.  The relabel dedups, so results
    stay correct; only the sampling statistics carry the ~0.1% noise.
    """
    B = seeds.shape[0]
    dev = seeds.device
    start, deg, valid = _row_extents(graph, seeds)
    j = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k)

    if replace:
        bits = draw_keys(key, (B, k), dev)
        sel = prng.uniform_mod(bits, deg[:, None])
        mask = (valid & (deg > 0))[:, None].expand(B, k)
    else:
        row_key = draw_keys(key, (B,), dev)
        perm = prng.feistel_permutation(j, deg[:, None], row_key[:, None])
        sel = torch.where(deg[:, None] <= k, j, perm)
        mask = valid[:, None] & (j < torch.clamp(deg[:, None], max=k))

    if graph.num_edges == 0:
        mask = torch.zeros((B, k), dtype=torch.bool, device=dev)
        ids = torch.full((B, k), INVALID_ID, dtype=torch.int32, device=dev)
        return SampledNeighbors(ids=ids, mask=mask)
    pos = torch.clamp(start[:, None] + sel.long(), 0, graph.num_edges - 1)
    ids = torch.where(mask, graph.indices[pos], INVALID_ID)
    return SampledNeighbors(ids=ids, mask=mask.contiguous())


def sample_neighbors(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Dispatch on ``graph.probs`` like the JAX package.  Only uniform
    sampling is ported; a weighted graph raises."""
    if graph.probs is not None:
        raise NotImplementedError(
            "biased (weighted) sampling is not ported yet; drop graph.probs "
            "for uniform sampling"
        )
    return sample_uniform(graph, seeds, k, replace, key)
