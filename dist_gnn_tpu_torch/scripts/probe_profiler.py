"""Does a ``torch.profiler`` session keep its kernel records?

A probe runs four sessions of ``torch.profiler`` (CUDA activity only, as
``utils/timing.profile_device`` records), each around 10 small kernels
and a synchronize: ``bare`` opens right before the kernels and closes
right after the synchronize; ``head`` waits 50 ms before the kernels;
``tail`` stays open 50 ms after the synchronize; ``both`` does both, as
``profile_device`` does.  Each prints the kernel launches the session
saw, the kernel records it kept, and over the kept ones the least and
the most of (kernel start − launch start) in µs, matched by correlation
id.  One probe runs at once, then the process idles (one kernel a second)
for ``--idle-s``, then ``--probes`` more run 13 s apart.

The profiler keeps a kernel only if its CUPTI timestamp, mapped to the
host clock, falls inside the session; where that mapping drifts, the
start-minus-launch offsets show it, and the bare sessions lose records.
Run on the card: ``python3 -m dist_gnn_tpu_torch.scripts.probe_profiler``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
PAD_S = 0.05
MODES = {"bare": (0.0, 0.0), "head": (PAD_S, 0.0), "tail": (0.0, PAD_S), "both": (PAD_S, PAD_S)}


def session(xs, head_s: float, tail_s: float) -> dict:
    """One profiler session around ``len(xs)`` kernels: launches seen,
    kernel records kept, and the kept kernels' start-minus-launch µs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(head_s)
        for x in xs:
            torch.mul(x, 2.0)
        torch.cuda.synchronize()
        time.sleep(tail_s)
    launch_ns, kernel_evs = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(LAUNCH_CALLS):
            launch_ns[ev.correlation_id()] = ev.start_ns()
        elif ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.name().startswith(("Memcpy", "Memset")):
            kernel_evs.append(ev)
    offs = []
    for ev in kernel_evs:
        for corr in (ev.correlation_id(), ev.linked_correlation_id()):
            if corr in launch_ns:
                offs.append((ev.start_ns() - launch_ns[corr]) / 1e3)
                break
    return {"launches": len(launch_ns), "kept": len(kernel_evs),
            "start_minus_launch_us": [min(offs), max(offs)] if offs else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--idle-s", type=float, default=150.0)
    ap.add_argument("--probes", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler needs a CUDA device")
    xs = [torch.randn((i + 1) << 16, device="cuda") for i in range(10)]
    t0 = time.perf_counter()

    def probe():
        row = {mode: session(xs, *pads) for mode, pads in MODES.items()}
        print(json.dumps({"t_s": round(time.perf_counter() - t0, 1), **row}), flush=True)

    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    probe()
    while time.perf_counter() - t0 < args.idle_s:
        torch.mul(xs[0], 2.0)
        torch.cuda.synchronize()
        time.sleep(1.0)
    for i in range(args.probes):
        probe()
        if i + 1 < args.probes:
            time.sleep(13.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
