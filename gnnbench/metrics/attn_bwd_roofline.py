"""The attention backward's bound (``rooflines/attn_bwd.py``: K5's and
K9-bwd's, each on its own; the first layer computes no input gradient)
over every layer of the traced transformer steps, over the device time of
the kernels that backward launches (K5's row and weight kernels and
K9-bwd, named by fragments), in %."""

from gnnbench import trace
from gnnbench.rooflines import attn_bwd


def read(record):
    if "steps" not in record or record["family"] != "transformer":
        return None
    seconds = trace.kernel_seconds(record["trace"], "gat_bwd_", "gat_dw_", "attn_score_bwd")
    if seconds <= 0:
        return None
    bound = 0.0
    for blocks in record["blocks"]:
        for l, b in enumerate(blocks):
            S, k = b.neigh_slots.shape
            E, D = record["dims"][l]
            bound += attn_bwd.layer_seconds(S, k, E, record["heads"], D, int(b.seed_mask.sum()),
                                            int(b.neigh_mask.sum()), need_dx=l > 0)
    return 100.0 * bound / seconds
