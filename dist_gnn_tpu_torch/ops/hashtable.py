"""Cache routing table: node id → cache slot (or miss).

Counterpart of ``dist_gnn_tpu/ops/hashtable.py``: a sorted id array and a
vectorised binary search (``torch.searchsorted``) map each id to its slot,
the role of the reference's open-addressing hashmap.  Duplicate ids are
resolved at build time by an explicit priority, the lowest winning, which
gives the reference's local-copy-wins rule with priority 0 for local and
1 for remote entries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def np_in_sorted(table: np.ndarray, ids) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side membership probe of a SORTED id array: ``(member [bool],
    pos [intp])`` with ``pos`` clipped into the table (all False and zeros
    for an empty table).  The device-side twin is :class:`SortedIdTable`."""
    ids = np.asarray(ids)
    if len(table) == 0:
        return np.zeros(len(ids), bool), np.zeros(len(ids), np.int64)
    pos = np.clip(np.searchsorted(table, ids), 0, len(table) - 1)
    return table[pos] == ids, pos


@dataclasses.dataclass(frozen=True)
class SortedIdTable:
    """Maps id → slot for a cached id set: ``slots[i]`` is the cache row of
    ``sorted_ids[i]``, its position in the ids the table was built from;
    :meth:`lookup` returns (slot, hit).  ``owners``, when built with one,
    is the owning device of each id (the peer-hot routing table,
    ``parallel/feature_store.build_union_tables``)."""

    sorted_ids: torch.Tensor  # [C] int32, strictly increasing
    slots: torch.Tensor  # [C] int32 — cache row per id
    owners: Optional[torch.Tensor] = None  # [C] int32 — owning device per id

    @staticmethod
    def build(
        cache_nids: np.ndarray,
        priority: Optional[np.ndarray] = None,
        device: DeviceLike = None,
        owners: Optional[np.ndarray] = None,
    ) -> "SortedIdTable":
        """Host-side build, placed on ``device`` (default: the card).  On
        duplicate ids the entry with the lowest ``priority`` wins, and its
        ``owners`` entry with it."""
        dev = resolve_device(device)
        cache_nids = np.asarray(cache_nids, dtype=np.int32)
        n = len(cache_nids)
        if priority is None:
            priority = np.zeros(n, dtype=np.int32)
        order = np.lexsort((priority, cache_nids))
        ids_s = cache_nids[order]
        keep = np.ones(n, dtype=bool)
        keep[1:] = ids_s[1:] != ids_s[:-1]  # first (lowest priority) wins
        order = order[keep]
        return SortedIdTable(
            sorted_ids=torch.from_numpy(cache_nids[order]).to(dev),
            slots=torch.from_numpy(order.astype(np.int32)).to(dev),
            owners=(
                None if owners is None
                else torch.from_numpy(np.asarray(owners, np.int32)[order]).to(dev)
            ),
        )

    @property
    def sorted_ids_np(self) -> np.ndarray:
        return self.sorted_ids.cpu().numpy()

    def lookup(self, nids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slot, hit) per query id; misses return slot 0 with hit False."""
        nids = nids.to(torch.int32)
        C = self.sorted_ids.shape[0]
        if C == 0:
            return torch.zeros_like(nids), torch.zeros(nids.shape, dtype=torch.bool, device=nids.device)
        pos = torch.clamp(torch.searchsorted(self.sorted_ids, nids), max=C - 1)
        hit = self.sorted_ids[pos] == nids
        return torch.where(hit, self.slots[pos], 0), hit
