"""Unique + relabel with static capacity (sort-based compaction).

Counterpart of ``dist_gnn_tpu/ops/relabel.py``.  One stable sort gives
exactly the outputs of both JAX variants (``unique_and_relabel`` and
``unique_and_relabel_dense``; which of them runs is a TPU cost choice):

* capacity is ``S + B*k``; the frontier is INVALID_ID padded with a mask
  and a count;
* positional seeds-first invariant: ``frontier[i] == seeds[i]`` for i < S,
  padding included;
* new unique neighbour ids follow from slot S in ascending id order;
* a neighbour equal to a seed maps to that seed's slot (the first such
  seed), duplicates map to one slot, masked slots map to 0.

Everything stays on the device: no step reads a count back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dist_gnn_tpu_torch.graph import INVALID_ID


class RelabeledFrontier(NamedTuple):
    frontier: torch.Tensor  # [S + B*k] int32 global ids, INVALID padded
    frontier_mask: torch.Tensor  # [capacity] bool
    num_frontier: torch.Tensor  # [] int32 — count of valid frontier entries
    neigh_slots: torch.Tensor  # [B, k] int32 — neighbour positions in frontier


def unique_and_relabel(
    seeds: torch.Tensor,  # [S] int32, INVALID padded
    neigh_ids: torch.Tensor,  # [B, k] int32, INVALID on masked slots
    neigh_mask: torch.Tensor,  # [B, k] bool
) -> RelabeledFrontier:
    S = seeds.shape[0]
    B, k = neigh_ids.shape
    cap = S + B * k
    dev = seeds.device

    flat_n = torch.where(neigh_mask.reshape(-1), neigh_ids.reshape(-1), INVALID_ID)
    ids = torch.cat([seeds.to(torch.int32), flat_n.to(torch.int32)])
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    valid = ids != INVALID_ID

    # stable sort == lexicographic (id, position) order: each group's first
    # element holds the group's smallest position
    s_ids, s_pos = torch.sort(ids, stable=True)
    s_valid = s_ids != INVALID_ID
    first = s_valid.clone()
    first[1:] &= s_ids[1:] != s_ids[:-1]
    lead_idx = torch.cummax(torch.where(first, pos, -1), dim=0).values
    lead_pos = s_pos[lead_idx.clamp(min=0)]  # min position of the group

    lead_is_seed = lead_pos < S
    is_new_group = first & ~lead_is_seed
    new_rank = torch.cumsum(is_new_group.to(torch.int64), dim=0) - 1
    group_slot = torch.where(lead_is_seed, lead_pos, S + new_rank)
    slot_sorted = torch.where(s_valid, group_slot, 0)

    slots = torch.empty(cap, dtype=torch.int64, device=dev)
    slots[s_pos] = slot_sorted  # s_pos is a permutation
    slots = torch.where(valid, slots, 0)

    num_new = is_new_group.sum()
    num_frontier = (num_new + (seeds != INVALID_ID).sum()).to(torch.int32)

    # new ids land at S + rank; every other sorted entry aims at the spare
    # slot `cap`, which is cut off afterwards
    buf = torch.full((cap + 1,), INVALID_ID, dtype=torch.int32, device=dev)
    buf.scatter_(0, torch.where(is_new_group, S + new_rank, cap), s_ids)
    frontier = buf[:cap]
    frontier[:S] = seeds
    frontier_mask = torch.where(
        pos < S, frontier != INVALID_ID, pos < S + num_new
    )
    neigh_slots = slots[S:].reshape(B, k).to(torch.int32)
    return RelabeledFrontier(
        frontier=frontier,
        frontier_mask=frontier_mask,
        num_frontier=num_frontier,
        neigh_slots=torch.where(neigh_mask, neigh_slots, 0),
    )
