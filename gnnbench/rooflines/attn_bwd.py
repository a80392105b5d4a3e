"""The dot-product attention backward of one transformer layer (shapes as
``attn_fwd``), as the kernels that run it need: K5's bound
(``k5_gat_bwd``), and K9-bwd's: the valid slots' neighbour rows (bf16),
the folded queries [H, S, E] (bf16), the valid slots' score gradients (f32)
and the f32 mask read once, the folded queries' gradient written once, and
with ``need_dx`` the valid slots' input gradients read and written once
(K9-bwd adds into K5's); operations 2 V E H for the queries' gradient and
as many for the inputs'.  Each kernel's bound is taken on its own and the
two summed."""

from __future__ import annotations

from gnnbench import peaks
from gnnbench.rooflines import k5_gat_bwd


def score_bwd_cost(S: int, k: int, E: int, H: int, valid_slots: int, need_dx: bool):
    """K9-bwd's ``(bytes, flops)``."""
    nbytes = valid_slots * E * 2 + 2 * S * H * E * 2 + valid_slots * H * 4 + S * k * 4
    nbytes += 2 * valid_slots * E * 2 if need_dx else 0
    flops = 2 * valid_slots * E * H * (2 if need_dx else 1)
    return nbytes, flops


def layer_seconds(S: int, k: int, E: int, H: int, D: int, valid_rows: int, valid_slots: int,
                  need_dx: bool) -> float:
    """The bound of one layer's backward kernels, in seconds."""
    total = 0.0
    for nb, fl in (k5_gat_bwd.layer_cost(S, k, E, H, D, valid_rows, valid_slots, need_dx),
                   score_bwd_cost(S, k, E, H, valid_slots, need_dx)):
        total += max(nb / peaks.HBM_BYTES_PER_S, fl / peaks.BF16_FLOPS)
    return total
