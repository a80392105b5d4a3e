"""K4's bound (the larger of bytes at the peak bandwidth and operations at
the bf16 peak, ``rooflines/k4_gat_fwd.py``) over every layer of the traced
GAT steps, over K4's device time, in %."""

from gnnbench import peaks, trace
from gnnbench.rooflines import k4_gat_fwd


def read(record):
    if "steps" not in record or record["family"] != "gat":
        return None
    seconds = trace.kernel_seconds(record["trace"], "gat_fwd_")
    if seconds <= 0:
        return None
    bound = 0.0
    for blocks in record["blocks"]:
        for l, b in enumerate(blocks):
            S, k = b.neigh_slots.shape
            E, D = record["dims"][l]
            nb, fl = k4_gat_fwd.layer_cost(S, k, E, record["heads"], D, int(b.seed_mask.sum()),
                                           int(b.neigh_mask.sum()))
            bound += max(nb / peaks.HBM_BYTES_PER_S, fl / peaks.BF16_FLOPS)
    return 100.0 * bound / seconds
