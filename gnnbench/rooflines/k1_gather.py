"""K1, the feature row gather ``table[idx]``: every distinct row read
once, every index (4 bytes) read once and every output row written once."""

from __future__ import annotations

import torch


def call_bytes(idx: torch.Tensor, row_bytes: int) -> int:
    return int(torch.unique(idx).numel()) * row_bytes + idx.shape[0] * (4 + row_bytes)
