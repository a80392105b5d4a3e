"""Plain multi-hop neighbour sampling: the blocks a mini-batch should get.

For each hop (in sampling order, the last entry of the fanout first):

* a row with degree ``d <= k`` takes its first ``d`` in-neighbours, a
  longer row the positions ``permute(j, d, row_key)`` for ``j < k``;
* every hop but the last relabels: the frontier is the hop's seeds in
  place (padding included), then the distinct new neighbour ids in
  ascending order; a neighbour equal to a seed points at that seed's first
  slot; a frontier cap keeps the first ``cap`` slots, and neighbours past
  it are masked;
* the last hop keeps every sampled slot: the frontier is
  ``[seeds; ids[:, 0]; ids[:, 1]; ...]`` and slot ``S + j*B + i`` is row
  ``i``'s ``j``-th neighbour.

Everything is plain torch on whatever device the inputs lie.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from gnnbench.reference import prng

INVALID = 2**31 - 1


class RefBlock(NamedTuple):
    seeds: torch.Tensor  # [S] int32
    seed_mask: torch.Tensor  # [S] bool
    frontier: torch.Tensor  # [cap] int32
    frontier_mask: torch.Tensor  # [cap] bool
    num_frontier: torch.Tensor  # [] int64
    neigh_slots: torch.Tensor  # [S, k] int32
    neigh_mask: torch.Tensor  # [S, k] bool


def positions(indptr, seeds, k: int, row_key):
    """``(pos, mask)``: the [B, k] edge positions the slots read (clamped
    into the edge list) and which slots are taken (without replacement)."""
    valid = seeds != INVALID
    safe = torch.where(valid, seeds, 0).long()
    start = indptr[safe].long()
    deg = torch.where(valid, indptr[safe + 1].long() - start, 0)
    j = torch.arange(k, dtype=torch.int64, device=seeds.device)[None, :]
    perm = prng.permute(j, deg[:, None], row_key[:, None])
    sel = torch.where(deg[:, None] <= k, j, perm)
    mask = valid[:, None] & (j < torch.clamp(deg[:, None], max=k))
    nnz = int(indptr[-1])
    return torch.clamp(start[:, None] + sel, 0, max(nnz - 1, 0)), mask


def sample_hop(indptr, indices, seeds, k: int, row_key):
    pos, mask = positions(indptr, seeds, k, row_key)
    ids = torch.where(mask, indices[pos].to(torch.int32), INVALID)
    return ids, mask


def relabel(seeds, seed_mask, ids, mask, cap: Optional[int]) -> RefBlock:
    S = seeds.shape[0]
    B, k = ids.shape
    dev = seeds.device
    full = S + B * k
    seed_ids = seeds.long()
    valid_seed = seed_ids != INVALID
    nb = ids.long()
    # the first slot of each distinct seed id
    uniq_seeds, inv = torch.unique(seed_ids[valid_seed], return_inverse=True)
    first_pos = torch.full((uniq_seeds.numel(),), full, dtype=torch.int64, device=dev)
    first_pos.scatter_reduce_(0, inv, torch.nonzero(valid_seed)[:, 0], "amin")
    taken = nb[mask]
    uniq_nb = torch.unique(taken)
    new_ids = uniq_nb[~torch.isin(uniq_nb, uniq_seeds)]
    num_new = new_ids.numel()

    frontier = torch.full((full,), INVALID, dtype=torch.int64, device=dev)
    frontier[:S] = seed_ids
    frontier[S : S + num_new] = new_ids
    frontier_mask = torch.cat([valid_seed, torch.arange(B * k, device=dev) < num_new])

    if uniq_seeds.numel():
        at = torch.searchsorted(uniq_seeds, nb).clamp(max=uniq_seeds.numel() - 1)
        is_seed = uniq_seeds[at] == nb
        seed_slot = first_pos[at]
    else:
        is_seed = torch.zeros_like(mask)
        seed_slot = torch.zeros_like(nb)
    new_slot = S + torch.searchsorted(new_ids, nb)
    slots = torch.where(mask, torch.where(is_seed, seed_slot, new_slot), 0)
    num_frontier = valid_seed.sum() + num_new
    neigh_mask = mask
    if cap is not None and cap < full:
        keep = slots < cap
        neigh_mask = mask & keep
        slots = torch.where(keep, slots, 0)
        frontier, frontier_mask = frontier[:cap], frontier_mask[:cap]
        num_frontier = torch.clamp(num_frontier, max=cap)
    return RefBlock(seeds, seed_mask, frontier.to(torch.int32), frontier_mask, num_frontier,
                    slots.to(torch.int32), neigh_mask)


def flat_block(seeds, seed_mask, ids, mask) -> RefBlock:
    S = seeds.shape[0]
    B, k = ids.shape
    dev = seeds.device
    frontier = torch.cat([seeds.to(torch.int32), torch.where(mask, ids, INVALID).T.reshape(-1)])
    frontier_mask = torch.cat([seed_mask, mask.T.reshape(-1)])
    j = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    i = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    slots = torch.where(mask, S + j * B + i, 0).to(torch.int32)
    return RefBlock(seeds, seed_mask, frontier, frontier_mask, frontier_mask.sum(), slots, mask)


def sample_blocks(indptr, indices, seeds, seed_mask, fanout: Sequence[int],
                  caps: Optional[Sequence[int]], hop_keys: Sequence[torch.Tensor]) -> List[RefBlock]:
    """Blocks in sampling order (``[0]`` holds the mini-batch), the last
    hop without relabelling."""
    blocks = []
    ks = list(reversed(list(fanout)))
    for i, k in enumerate(ks):
        ids, mask = sample_hop(indptr, indices, seeds, k, hop_keys[i])
        if i == len(ks) - 1:
            blocks.append(flat_block(seeds, seed_mask, ids, mask))
            break
        cap = None if caps is None else int(caps[i])
        blk = relabel(seeds, seed_mask, ids, mask, cap)
        blocks.append(blk)
        seeds, seed_mask = blk.frontier, blk.frontier_mask
    return blocks


def hop_sizes(batch: int, fanout: Sequence[int], caps: Optional[Sequence[int]]) -> List[int]:
    """The seed count of every hop (sampling order), the row keys it takes."""
    sizes = [batch]
    for i, k in enumerate(list(reversed(list(fanout)))[:-1]):
        full = sizes[-1] * (k + 1)
        sizes.append(full if caps is None else min(full, int(caps[i])))
    return sizes
