"""The 95th percentile of a training step's time in steady state, in ms:
the gaps between the CUDA events that end consecutive untraced steps of
the traced run's steady stretch (seconds of steps, no synchronise inside)."""

from gnnbench import common


def read(record):
    gaps = record.get("steady_step_ms")
    return common.p95(gaps) if gaps else None
