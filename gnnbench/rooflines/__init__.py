"""The bytes and operations that a kernel's inputs need, from their shapes
and contents: each input byte read once, each output byte written once,
and where the work depends on the data, only what these inputs need.
The bound of a call is the larger of bytes over the peak bandwidth and
operations over the peak rate (``gnnbench/peaks.py``)."""
