"""K3's backward, one layer: the slot transpose that the forward builds for
it (slots and mask read, the count array of ``cap + 1`` int32 written, the
transposed (slot, row) pairs of the valid slots written, a row offset per
destination row) and the gather-form backward (the output gradient
[S, F] read, slots and mask read, the input gradient [cap, F] written), in
the element size of the activations."""

from __future__ import annotations

import torch


def layer_bytes(slots: torch.Tensor, mask: torch.Tensor, cap: int, width: int, elem: int = 2) -> int:
    S, k = slots.shape
    transpose = S * k * 5 + (cap + 1) * 4 + int(mask.sum()) * 8 + S * 4
    backward = S * width * elem + S * k * 5 + cap * width * elem
    return transpose + backward
