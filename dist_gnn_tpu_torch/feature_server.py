"""Feature stores: where node features live and how rows are fetched.

Counterpart of ``dist_gnn_tpu/feature_server.py``:

* :class:`HBMFeatureStore` — the whole feature matrix in device memory; a
  fetch is a masked K1 gather.
* :class:`CachedFeatureStore` — hot rows (from the heat/value policy,
  ``cache/policy.py``) in device memory behind a :class:`SortedIdTable`,
  cold rows in a host array; hits are a K1 gather, misses a host gather
  (``utils/native.gather_rows``) copied in.  It reads the miss set back to
  the host on every call; the training path stages misses ahead instead
  (``host_tier.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import INVALID_ID
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.ops.hashtable import SortedIdTable
from dist_gnn_tpu_torch.utils import native
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


class HBMFeatureStore:
    """Full feature matrix on one device; ``get_features`` = masked gather
    (K1 on the card)."""

    def __init__(self, features: torch.Tensor):
        self.features = features

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    def get_features(self, nids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = nids != INVALID_ID
        rows = gather_rows(self.features, torch.where(mask, nids, 0).to(torch.int32))
        return rows.masked_fill_(~mask[:, None], 0)


class CachedFeatureStore:
    """Hot rows on the device + a host-resident cold tier.

    ``cache_nids`` may carry the INVALID padding of a cache plan
    (``cache/builder.py``) and ids outside the feature matrix: both are
    dropped before the hot rows are gathered."""

    def __init__(self, host_features: np.ndarray, cache_nids: np.ndarray, device: DeviceLike = None):
        dev = resolve_device(device)
        ids = np.asarray(cache_nids, dtype=np.int64)
        ids = ids[(ids >= 0) & (ids < host_features.shape[0])]
        cache_sorted = np.unique(ids.astype(np.int32))
        self.table = SortedIdTable.build(cache_sorted, device=dev)
        self.hot = torch.from_numpy(native.gather_rows(host_features, cache_sorted)).to(dev)
        self.host_features = host_features

    @property
    def feature_dim(self) -> int:
        return self.host_features.shape[1]

    def hit_rate(self, nids) -> float:
        _, hit = self.table.lookup(torch.as_tensor(nids, device=self.hot.device))
        return float(hit.float().mean())

    def get_features(self, nids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = nids != INVALID_ID
        slots, hit = self.table.lookup(nids)
        hit = hit & mask
        out = gather_rows(self.hot, torch.where(hit, slots, 0)) if self.hot.shape[0] else (
            torch.zeros((nids.shape[0], self.feature_dim), dtype=self.hot.dtype, device=nids.device)
        )
        out.masked_fill_(~hit[:, None], 0)
        miss_idx = np.flatnonzero((mask & ~hit).cpu().numpy())
        if miss_idx.size:
            rows = native.gather_rows(self.host_features, nids.cpu().numpy()[miss_idx])
            out[torch.from_numpy(miss_idx).to(out.device)] = torch.from_numpy(rows).to(out)
        return out
