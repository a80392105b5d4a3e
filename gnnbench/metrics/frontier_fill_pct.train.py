"""The valid rows of every hop's frontier over its allotted rows, summed
over the hops and steps of the profiled session (the program's counters
``sample.frontier_rows`` and ``sample.frontier_alloc``,
``gnnbench/spans.py``), in %."""

from gnnbench import spans


def read(record):
    return spans.counter_share_pct(record, "train", "sample.frontier_rows", "sample.frontier_alloc")
