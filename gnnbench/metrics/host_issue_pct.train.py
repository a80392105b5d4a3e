"""Host time inside the program's `train_step` span of a step issued after
a synchronize, so from an empty launch queue (the median of
``gnnbench/spans.py``'s paced steps, tracing on), over the driver's steady
untraced step time, in %: under 100 the host issues a step faster than
the card runs it."""

from gnnbench import spans


def read(record):
    return spans.host_issue_pct(record, "train")
