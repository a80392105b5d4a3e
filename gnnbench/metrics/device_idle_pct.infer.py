"""The share of an untraced full-graph pass in steady state in which no
kernel, copy or memset ran on the card: the device time a traced pass
needed over the time an untraced pass took, in %."""


def read(record):
    if "passes" not in record:
        return None
    return 100.0 * (1.0 - record["trace"]["busy_s"] / record["passes"] / record["steady_pass_s"])
