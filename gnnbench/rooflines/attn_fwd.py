"""The dot-product attention forward of one transformer layer of S
destination rows, k slots, E input columns, H heads of D columns, in its
cheapest form: the valid slots' neighbour rows (bf16), the rows' inputs
(bf16), W_q, W_k and W_v [E, H*D] (bf16) and the f32 mask read once, the
[S, H*D] bf16 output written once; operations over the valid rows S_v and
slots V: the query and its fold through W_k (2 S_v E H D each), the scores
and the weighted sums (2 V E H each), and the value projection of the
weighted inputs (2 S_v E H D)."""

from __future__ import annotations


def layer_cost(S: int, k: int, E: int, H: int, D: int, valid_rows: int, valid_slots: int):
    """``(bytes, flops)``."""
    HD = H * D
    nbytes = valid_slots * E * 2 + S * E * 2 + 3 * E * HD * 2 + S * k * 4 + S * HD * 2
    flops = 3 * 2 * valid_rows * E * HD + 2 * 2 * valid_slots * E * H
    return nbytes, flops
