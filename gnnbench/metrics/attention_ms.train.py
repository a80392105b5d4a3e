"""Device ms a training step launched inside the transformer's attention
(`forward.attention`, every layer: the query and its fold, the scores, the
softmax, the weighted sum and the value projection): the kernels, copies
and memsets whose launch lies inside that span of the program's own
tracing, on the device trace's clock (``gnnbench/spans.py``)."""

from gnnbench import spans


def read(record):
    return spans.device_ms(record, "train", "forward.attention")
