"""Multi-layer neighbour sampler producing static-shape blocks.

Counterpart of ``dist_gnn_tpu/sampler.py``: per layer, in reverse fanout
order, sample → relabel → emit a block, with the frontier becoming the
next layer's seeds.  Every block is padded and masked to a fixed shape, and
the frontier keeps the positional seeds-first invariant, so the model
chains layers by slicing.

Each hop samples through ``ops/sampling.sample_neighbors``: K6 on an
unweighted graph, K8 on a weighted one with alias tables, K7 on a weighted
one without them (the graph decides, as in the JAX package).

The JAX package splits one key per hop (``jax.random.split(key,
len(fan_out))``).  Here ``key`` is a ``torch.Generator`` that draws every
hop's keys in turn, or a sequence of per-hop keys, each what the hop's
sampler takes (uniform and K7: ``row_key[B_i]`` for replace=False,
``bits[B_i, k_i]`` for replace=True; K8: see
``ops/sampling.alias_keys``), which is how tests inject the JAX package's
keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph
from dist_gnn_tpu_torch.ops.relabel import unique_and_relabel
from dist_gnn_tpu_torch.ops.sampling import sample_neighbors
from dist_gnn_tpu_torch.utils import trace


class Block(NamedTuple):
    """One message-passing layer, dst = seeds, src = frontier.

    Invariant: ``frontier[i] == seeds[i]`` for i < len(seeds), padding
    included.
    """

    seeds: torch.Tensor  # [S] int32 global ids (INVALID padded)
    seed_mask: torch.Tensor  # [S] bool
    frontier: torch.Tensor  # [S + S*k] int32 global ids (INVALID padded)
    frontier_mask: torch.Tensor  # [S + S*k] bool
    num_frontier: torch.Tensor  # [] int32
    neigh_slots: torch.Tensor  # [S, k] int32 — positions into frontier
    neigh_mask: torch.Tensor  # [S, k] bool

    @property
    def num_dst(self) -> int:
        return self.seeds.shape[0]

    @property
    def num_src(self) -> int:
        return self.frontier.shape[0]


def layer_capacities(batch_size: int, fan_out: Sequence[int]) -> List[int]:
    """Frontier capacity after each sampling hop (reverse fanout order)."""
    caps = [batch_size]
    for k in reversed(list(fan_out)):
        caps.append(caps[-1] * (k + 1))
    return caps


def _truncate_frontier(rl, budget: int):
    """Cap the frontier at ``budget`` slots.  New ids that were assigned
    slots >= budget are dropped: their neighbour entries are masked out and
    counted in ``overflow``.  Seeds always fit (budget >= num_seeds)."""
    overflow = torch.clamp(rl.num_frontier - budget, min=0)
    keep = rl.neigh_slots < budget
    return (
        rl.frontier[:budget],
        rl.frontier_mask[:budget],
        torch.clamp(rl.num_frontier, max=budget),
        torch.where(keep, rl.neigh_slots, 0),
        keep,
        overflow,
    )


def _no_dedup_block(seeds, seed_mask, nb) -> Block:
    """Frontier = [seeds; all sampled neighbours] without dedup, for the
    deepest hop, where dedup buys nothing downstream.

    Neighbour slots are laid out k-major: the frontier is
    ``[seeds; nb[:, 0]; nb[:, 1]; ...]``, so slot ``S + j*B + i`` holds row
    i's j-th neighbour and slot j of every row is a contiguous [B]-run."""
    S = seeds.shape[0]
    B, k = nb.ids.shape
    dev = seeds.device
    ids_km = torch.where(nb.mask, nb.ids, INVALID_ID).T  # [k, B]
    frontier = torch.cat([seeds, ids_km.reshape(-1)])
    frontier_mask = torch.cat([seed_mask, nb.mask.T.reshape(-1)])
    slots = (
        S
        + torch.arange(k, dtype=torch.int32, device=dev)[None, :] * B
        + torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    )
    return Block(
        seeds=seeds,
        seed_mask=seed_mask,
        frontier=frontier,
        frontier_mask=frontier_mask,
        num_frontier=frontier_mask.sum().to(torch.int32),
        neigh_slots=torch.where(nb.mask, slots, 0),
        neigh_mask=nb.mask,
    )


def _relabel_block(seeds, seed_mask, nb, cap: Optional[int]):
    """``(block, frontier overflow or None)`` of one deduplicated hop: the
    relabel, then the cut to ``cap`` slots when the frontier is longer."""
    rl = unique_and_relabel(seeds, nb.ids, nb.mask)
    if cap is None or cap >= rl.frontier.shape[0]:
        return Block(seeds, seed_mask, rl.frontier, rl.frontier_mask, rl.num_frontier, rl.neigh_slots, nb.mask), None
    if cap < seeds.shape[0]:
        raise ValueError(f"frontier cap {cap} must cover the {seeds.shape[0]} seeds")
    frontier, frontier_mask, num_frontier, slots, keep, fovf = _truncate_frontier(rl, cap)
    return Block(seeds, seed_mask, frontier, frontier_mask, num_frontier, slots, nb.mask & keep), fovf


def sample_blocks(
    graph: Graph,
    seeds: torch.Tensor,
    seed_mask: torch.Tensor,
    fan_out: Tuple[int, ...],
    replace: bool,
    key: Union[torch.Generator, Sequence],
    frontier_caps: Optional[Tuple[int, ...]] = None,
    dedup_last: bool = True,
):
    """Sample all layers; returns ``(blocks, stats)``.

    Blocks are ordered output-layer-first (``blocks[0].seeds`` is the
    mini-batch); reverse them for input-first model consumption.

    ``stats`` holds 0-d tensors: ``sampler_overflow`` (sampled slots masked
    because a draw budget fell short: the alias sampler's shortfall, summed
    over the hops on the device; 0 on the exact paths) and
    ``frontier_overflow`` (frontier entries dropped by ``frontier_caps``).

    ``frontier_caps`` (optional, one per hop in sampling order) bounds each
    layer's frontier to a budget below the worst case ``S*(k+1)``; dropped
    entries are masked and counted, never silently wrong.
    """
    if not isinstance(key, torch.Generator) and len(key) != len(fan_out):
        raise ValueError(f"need {len(fan_out)} per-hop keys, got {len(key)}")

    def hop(i, s, _mask, k):
        nb = sample_neighbors(graph, s, k, replace, key if isinstance(key, torch.Generator) else key[i])
        return nb, nb.overflow

    return blocks_from_hops(hop, seeds, seed_mask, fan_out, frontier_caps, dedup_last)


def blocks_from_hops(
    sample_hop: Callable,
    seeds: torch.Tensor,
    seed_mask: torch.Tensor,
    fan_out: Tuple[int, ...],
    frontier_caps: Optional[Tuple[int, ...]] = None,
    dedup_last: bool = True,
):
    """The layer loop of :func:`sample_blocks` over any per-hop sampler:
    ``sample_hop(i, seeds, seed_mask, k) -> (SampledNeighbors, overflow)``
    samples hop ``i`` (the distributed trainer's owner-side sampler is
    one).  Returns ``(blocks, stats)`` as :func:`sample_blocks` does.

    Each hop is two spans of ``utils/trace``, ``sample.draw`` and
    ``sample.relabel`` (attr ``hop``), and adds its frontier's valid rows
    (the 0-d ``num_frontier``) and allotted rows to the counters
    ``sample.frontier_rows`` and ``sample.frontier_alloc``."""
    dev = seeds.device
    blocks = []
    samp_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    front_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    for i, k in enumerate(reversed(list(fan_out))):
        with trace.span("sample.draw", hop=i):
            nb, ovf = sample_hop(i, seeds, seed_mask, k)
            samp_ovf = samp_ovf + ovf
        last = not dedup_last and i == len(fan_out) - 1
        with trace.span("sample.relabel", hop=i):
            if last:
                block = _no_dedup_block(seeds, seed_mask, nb)
            else:
                block, fovf = _relabel_block(seeds, seed_mask, nb, None if frontier_caps is None else frontier_caps[i])
                if fovf is not None:
                    front_ovf = front_ovf + fovf.to(torch.int32)
        trace.count("sample.frontier_rows", block.num_frontier)
        trace.count("sample.frontier_alloc", block.frontier.shape[0])
        blocks.append(block)
        if last:
            break
        seeds = block.frontier
        seed_mask = block.frontier_mask
    return tuple(blocks), {
        "sampler_overflow": samp_ovf,
        "frontier_overflow": front_ovf,
    }


@dataclasses.dataclass
class NeighborSampler:
    """The graph plus its sampling config; :meth:`sample` per mini-batch."""

    graph: Graph
    fan_out: Tuple[int, ...]
    replace: bool = False
    frontier_caps: Optional[Tuple[int, ...]] = None
    dedup_last: bool = True

    def structure_tensors(self):
        """The structure this sampler draws from, ``(indptr, indices,
        probs or None)``: the reference's ``GetCPUStructureTensors``.  On
        one device the graph itself is the cache, so the cached and base
        structure coincide; the sharded getters are
        ``parallel.graph_dist.ShardedGraph``'s."""
        return self.graph.indptr, self.graph.indices, self.graph.probs

    def sample(self, seeds, seed_mask, key):
        """Returns ``(blocks, stats)`` — see :func:`sample_blocks`."""
        return sample_blocks(
            self.graph,
            seeds,
            seed_mask,
            tuple(self.fan_out),
            self.replace,
            key,
            frontier_caps=self.frontier_caps,
            dedup_last=self.dedup_last,
        )
