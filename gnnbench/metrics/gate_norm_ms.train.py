"""Device ms a training step launched inside the transformer's gated
residual (`forward.gate`, every layer: the root projection, the gate, the
mix, and on hidden layers the LayerNorm and the ReLU): the kernels, copies
and memsets whose launch lies inside that span of the program's own
tracing, on the device trace's clock (``gnnbench/spans.py``)."""

from gnnbench import spans


def read(record):
    return spans.device_ms(record, "train", "forward.gate")
