"""K5's bound (``rooflines/k5_gat_bwd.py``; the first layer computes no
input gradient) over every layer of the traced GAT steps, over the device
time of K5's row and weight kernels, in %."""

from gnnbench import peaks, trace
from gnnbench.rooflines import k5_gat_bwd


def read(record):
    if "steps" not in record or record["family"] != "gat":
        return None
    seconds = trace.kernel_seconds(record["trace"], "gat_bwd_", "gat_dw_")
    if seconds <= 0:
        return None
    bound = 0.0
    for blocks in record["blocks"]:
        for l, b in enumerate(blocks):
            S, k = b.neigh_slots.shape
            E, D = record["dims"][l]
            nb, fl = k5_gat_bwd.layer_cost(S, k, E, record["heads"], D, int(b.seed_mask.sum()),
                                           int(b.neigh_mask.sum()), need_dx=l > 0)
            bound += max(nb / peaks.HBM_BYTES_PER_S, fl / peaks.BF16_FLOPS)
    return 100.0 * bound / seconds
