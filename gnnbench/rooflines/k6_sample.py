"""K6, the uniform sampler without replacement, one hop: the distinct
32-byte sectors of ``indices`` that the taken slots read and of ``indptr``
that the valid seeds' extents read, every seed (4 bytes) and row key
(8 bytes) read once, and ids (4 bytes) and mask (1 byte) written once a
slot.  The positions are the plain sampler's (``reference/sampler.py``)."""

from __future__ import annotations

import torch

from gnnbench.reference.sampler import INVALID, positions


def sectors(base: int, itemsize: int, index: torch.Tensor) -> int:
    return int(torch.unique((base + itemsize * index.long()) // 32).numel())


def hop_bytes(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor, k: int,
              row_key: torch.Tensor) -> int:
    pos, mask = positions(indptr, seeds, k, row_key)
    sv = seeds[seeds != INVALID].long()
    B = seeds.shape[0]
    return ((sectors(indices.data_ptr(), indices.element_size(), pos[mask])
             + sectors(indptr.data_ptr(), indptr.element_size(), torch.cat([sv, sv + 1]))) * 32
            + B * 4 + row_key.numel() * 8 + B * k * 5)
