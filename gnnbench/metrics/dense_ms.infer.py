"""Device ms a full-graph pass launched inside every layer's dense part
(`infer.dense`: the layer's products, or GAT's projection and combine, and
the ReLU): the kernels, copies and memsets whose launch lies inside that
span of the program's own tracing, on the device trace's clock
(``gnnbench/spans.py``)."""

from gnnbench import spans


def read(record):
    return spans.device_ms(record, "infer", "infer.dense")
