"""K3's backward with its slot transposes (``rooflines/k3_bwd.py``): the
byte bound of every layer that takes an input gradient in the traced SAGE
steps at the peak bandwidth, over the device time of the backward and
transpose kernels, in %."""

from gnnbench import peaks, trace
from gnnbench.rooflines import k3_bwd


def read(record):
    if "steps" not in record or record["family"] != "sage":
        return None
    seconds = trace.kernel_seconds(record["trace"], "gather_mean_bwd", "transpose_")
    if seconds <= 0:
        return None
    nbytes = 0
    for blocks in record["blocks"]:
        for l in range(1, len(blocks)):  # layer 0's input, the features, takes no gradient
            b = blocks[l]
            nbytes += k3_bwd.layer_bytes(b.neigh_slots, b.neigh_mask, b.frontier.shape[0], record["dims"][l][0])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / seconds
