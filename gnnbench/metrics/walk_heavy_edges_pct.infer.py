"""The in-edges of the rows K3-csr gives one block each (the heavy rows:
more than its light limit of in-edges) over all the edges it walks, summed
over the layers of the profiled pass (the program's counters
``infer.walk_heavy_edges`` and ``infer.walk_edges``, ``gnnbench/spans.py``),
in %.  A program without K3-csr counts neither and reads None."""

from gnnbench import spans


def read(record):
    return spans.counter_share_pct(record, "infer", "infer.walk_heavy_edges", "infer.walk_edges")
