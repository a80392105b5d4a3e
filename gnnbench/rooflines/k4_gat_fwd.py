"""K4, the fused GAT attention forward, one layer of S destination rows, k
slots, E input columns, H heads of D columns: the valid slots' neighbour
rows (bf16) and score halves (f32), the rows' score halves, the f32 mask,
the projection [E, H*D] read once, the [S, H*D] bf16 output written once;
operations 2 V E H for the weighted sums and 2 S_v E H D for the
projection of the valid rows."""

from __future__ import annotations


def layer_cost(S: int, k: int, E: int, H: int, D: int, valid_rows: int, valid_slots: int):
    """``(bytes, flops)``."""
    HD = H * D
    nbytes = valid_slots * E * 2 + S * H * 4 + valid_slots * H * 4 + S * k * 4 + E * HD * 2 + S * HD * 2
    flops = 2 * valid_slots * E * H + 2 * valid_rows * E * HD
    return nbytes, flops
