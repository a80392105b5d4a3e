"""Device ms a full-graph pass launched inside the graph's upload, its edge
rows and degrees (`infer.upload`): the kernels, copies and memsets whose
launch lies inside that span of the program's own tracing, on the device
trace's clock (``gnnbench/spans.py``)."""

from gnnbench import spans


def read(record):
    return spans.device_ms(record, "infer", "infer.upload")
