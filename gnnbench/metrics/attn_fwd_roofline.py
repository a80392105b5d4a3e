"""The attention forward's bound (the larger of bytes at the peak bandwidth
and operations at the bf16 peak, ``rooflines/attn_fwd.py``) over every
layer of the traced transformer steps, a step's worth, over the device
time a step launched inside `forward.attention` (whatever kernels run
there, ``gnnbench/spans.py``), in %."""

from gnnbench import peaks, spans
from gnnbench.rooflines import attn_fwd


def read(record):
    if "steps" not in record or record["family"] != "transformer" or not record["blocks"]:
        return None
    ms = spans.device_ms(record, "train", "forward.attention")
    if not ms:
        return None
    bound = 0.0
    for blocks in record["blocks"]:
        for l, b in enumerate(blocks):
            S, k = b.neigh_slots.shape
            E, D = record["dims"][l]
            nb, fl = attn_fwd.layer_cost(S, k, E, record["heads"], D, int(b.seed_mask.sum()),
                                         int(b.neigh_mask.sum()))
            bound += max(nb / peaks.HBM_BYTES_PER_S, fl / peaks.BF16_FLOPS)
    return 100.0 * bound / len(record["blocks"]) / (ms * 1e-3)
