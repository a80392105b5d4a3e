"""The share of an untraced training step in steady state in which no
kernel, copy or memset ran on the card: the device time a traced step
needed over the time an untraced step took, in %."""


def read(record):
    if "steps" not in record:
        return None
    return 100.0 * (1.0 - record["trace"]["busy_s"] / record["steps"] / record["steady_step_s"])
