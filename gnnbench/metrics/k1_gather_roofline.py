"""K1's byte bound (``rooflines/k1_gather.py``) of the traced steps'
feature gathers at the peak bandwidth, over K1's device time, in %."""

import torch

from gnnbench import peaks, trace
from gnnbench.rooflines import k1_gather


def read(record):
    if "steps" not in record:
        return None
    seconds = trace.kernel_seconds(record["trace"], "gather_rows_kernel")
    if seconds <= 0:
        return None
    nbytes = 0
    for blocks in record["blocks"]:
        b = blocks[0]  # input-first: the deepest frontier's rows
        idx = torch.where(b.frontier_mask, b.frontier, 0)
        nbytes += k1_gather.call_bytes(idx, record["feature_row_bytes"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / seconds
