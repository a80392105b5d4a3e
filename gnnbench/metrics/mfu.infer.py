"""Model operations of a full-graph pass (counted by the family's
reference module) over the time an untraced pass took in steady state, at
the bf16 dense peak, in %."""

from gnnbench import peaks
from gnnbench.reference import models


def read(record):
    if "passes" not in record:
        return None
    flops = models.family(record["family"]).full_flops(record["cfg"], record["num_nodes"], record["num_edges"])
    return 100.0 * flops / (record["steady_pass_s"] * peaks.BF16_FLOPS)
