"""Host-side kernel launch calls (every profiler record whose name starts
with cudaLaunchKernel, cuLaunchKernel or cudaLaunchCooperativeKernel) over
the traced training steps."""


def read(record):
    if "steps" not in record or not record["steps"]:
        return None
    return record["trace"]["launches"] / record["steps"]
