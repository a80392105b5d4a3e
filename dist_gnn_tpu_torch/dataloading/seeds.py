"""Epoch seed batching with static shapes.

Counterpart of ``dist_gnn_tpu/dataloading/seeds.py``: shuffle once per
epoch, then yield fixed-size batches.  The last partial batch is padded
with INVALID_ID and a mask instead of being ragged.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import INVALID_ID
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


class SeedGenerator:
    def __init__(
        self,
        data,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.data = torch.as_tensor(np.asarray(data, dtype=np.int32)).to(self.device)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        n = self.data.shape[0]
        if drop_last:
            self.num_batches = n // self.batch_size
        else:
            self.num_batches = -(-n // self.batch_size)

    def __len__(self) -> int:
        return self.num_batches

    def epoch(
        self, generator: Optional[torch.Generator] = None
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield ``(seeds[batch_size], mask[batch_size])`` pairs.  With
        ``shuffle``, the order is a permutation drawn from ``generator``."""
        n = self.data.shape[0]
        data = self.data
        if self.shuffle:
            if generator is None:
                raise ValueError("a shuffled epoch needs a torch.Generator")
            perm = torch.randperm(n, generator=generator, device=generator.device)
            data = data[perm.to(self.device)]
        pad = self.num_batches * self.batch_size - n
        if pad > 0:
            data = torch.cat(
                [data, torch.full((pad,), INVALID_ID, dtype=torch.int32, device=self.device)]
            )
        elif pad < 0:  # drop_last truncation
            data = data[: self.num_batches * self.batch_size]
        batches = data.reshape(self.num_batches, self.batch_size)
        for i in range(self.num_batches):
            seeds = batches[i]
            yield seeds, seeds != INVALID_ID
