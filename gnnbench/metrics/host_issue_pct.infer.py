"""Host time inside the program's `infer_pass` span of a pass issued after
a synchronize, so from an empty launch queue (the median of
``gnnbench/spans.py``'s paced passes, tracing on), over the driver's
steady untraced pass time, in %."""

from gnnbench import spans


def read(record):
    return spans.host_issue_pct(record, "infer")
