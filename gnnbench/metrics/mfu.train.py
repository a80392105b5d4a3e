"""Model operations of a traced training step (forward and backward, from
each step's valid rows and slots, counted by the family's reference
module), over the time an untraced step took in steady state, at the bf16
dense peak, in %."""

from gnnbench import peaks
from gnnbench.reference import models


def read(record):
    if "steps" not in record:
        return None
    fam = models.family(record["family"])
    flops = sum(fam.train_flops(record["cfg"], rows, slots) for rows, slots in record["layer_counts"])
    return 100.0 * flops / record["steps"] / (record["steady_step_s"] * peaks.BF16_FLOPS)
