"""The valid slots of every attention layer's hop over its allotted slots
(S x k), summed over the layers and steps of the profiled session (the
program's counters ``attn.slots`` and ``attn.slot_alloc``,
``gnnbench/spans.py``), in %.  A program without the transformer counts
neither and reads None."""

from gnnbench import spans


def read(record):
    return spans.counter_share_pct(record, "train", "attn.slots", "attn.slot_alloc")
