"""Device ms a training step launched inside Adam's step (`optimizer`): the
kernels, copies and memsets whose launch lies inside that span of the
program's own tracing, on the device trace's clock
(``gnnbench/spans.py``)."""

from gnnbench import spans


def read(record):
    return spans.device_ms(record, "train", "optimizer")
