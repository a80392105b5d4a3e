"""K5, the fused GAT attention backward, one layer (shapes as K4): K4's
inputs and the output gradient [S, H*D] read once; the projection's
gradient (f32), the score halves' gradients, and with ``need_dx`` the
neighbour rows' gradients (bf16) written once; operations 4 S_v H D E for
the projection's two products and 2 V E H for each of the two or three
weighted-sum products."""

from __future__ import annotations


def layer_cost(S: int, k: int, E: int, H: int, D: int, valid_rows: int, valid_slots: int, need_dx: bool):
    """``(bytes, flops)``."""
    HD = H * D
    read = valid_slots * E * 2 + S * H * 4 + valid_slots * H * 4 + S * k * 4 + E * HD * 2 + S * HD * 2
    write = E * HD * 4 + S * H * 4 + valid_slots * H * 4 + (valid_slots * E * 2 if need_dx else 0)
    flops = 4 * valid_rows * HD * E + 2 * valid_slots * E * H * (3 if need_dx else 2)
    return read + write, flops
