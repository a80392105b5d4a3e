"""K6's byte bound (``rooflines/k6_sample.py``) of every hop of the traced
steps at the peak bandwidth, over the device time of every K6 kernel in
the traced window, in %."""

from gnnbench import peaks, trace
from gnnbench.rooflines import k6_sample


def read(record):
    if "steps" not in record:
        return None
    seconds = trace.kernel_seconds(record["trace"], "sample_uniform")
    if seconds <= 0:
        return None
    ks = list(reversed(list(record["fanout"])))
    nbytes = 0
    for blocks, keys in zip(record["blocks"], record["hop_keys"]):
        for i, b in enumerate(reversed(blocks)):  # sampling order
            nbytes += k6_sample.hop_bytes(record["indptr"], record["indices"], b.seeds, ks[i], keys[i])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / seconds
