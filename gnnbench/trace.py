"""Profiler sessions around a bounded stretch of the timed path, reduced in
memory to what the per-layer readers take.

A session writes its trace to a temporary file under ``TMPDIR``, reads it
back and deletes it.  The numbers come from sessions that record the
device's activity and the runtime calls alone (``torch.profiler`` with the
CUDA activity): recording every host op as well slows a host-paced step by
a third or more, and so inflates the idle share.  Their traced window runs
from the first runtime call to the end of the last device activity or of
the closing synchronise.  One more session records the host ops too, with
the work inside a ``gnnbench.window`` annotation, and only names the idle
gaps by the host op that launched the work ending each gap
(``idle_gaps``, which therefore come from a slower host).

Even the device sessions slow the host: a SAGE step that takes 11 ms
untraced took 20-41 ms traced (H100 host), so the traced window overstates
the idle share of a host-paced step.  So the drivers also time steps
untraced, in steady state (:func:`steady_seconds`: a few steps queued
first, no synchronise before the first event, seconds of steps), and the
idle share and the model FLOP rate take the device time a traced step
needed over the time an untraced step took.

The profiler can lose kernel records on a busy host (seen on the H100's
host: some sessions keep only part of the kernels they launched).  Every
launch is recorded on the host side, so the loss is counted: a session
that kept fewer kernel records than launches is run again, at most
``ATTEMPTS`` times in all, and the one that kept the largest share is
used, its per-kernel times and its busy time divided by that share.  The
share is reported beside the idle share (``kept_share``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

# host-side calls that each put one kernel on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "gnnbench.window"
ATTEMPTS = 4
PAD_S = 0.05
TOP = 10


def _short(name: str) -> str:
    """A kernel's name without its argument list and template arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.replace("void ", "").strip()[:100]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(events: List[Dict]) -> Dict:
    """The reduction of one session's chrome-trace events (times in us)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") in ("user_annotation", "cpu_op")]
    runtime = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:
        ends = [float(e["ts"]) + float(e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + ("cuda_runtime",)]
        if not runtime or not ends:
            raise RuntimeError("the trace holds no runtime call")
        w0, w1 = min(float(e["ts"]) for e in runtime), max(ends)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    cpu_ops = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"),
                     key=lambda e: float(e["ts"]))
    launches = sum(1 for e in runtime if str(e.get("name", "")).startswith(LAUNCH_CALLS)
                   and w0 <= float(e["ts"]) <= w1)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    kept = 0
    for e in dev:
        name = _short(str(e["name"])) if e["cat"] == "kernel" else str(e["cat"])
        kernels[name][0] += float(e["dur"]) * 1e-6
        kernels[name][1] += 1
        kept += e["cat"] == "kernel"
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    # idle gaps, named by the host op that launched the work ending each gap
    launch_ts = {}
    for e in runtime:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch_ts[corr] = float(e["ts"])
    starts = [float(e["ts"]) for e in cpu_ops]
    first_after = {}
    for e in dev:
        first_after.setdefault(float(e["ts"]), e)

    def host_op(ts: float) -> str:
        best = None
        i = bisect.bisect_right(starts, ts)
        for e in reversed(cpu_ops[max(0, i - 64) : i]):
            if float(e["ts"]) + float(e["dur"]) >= ts and (best is None or e["dur"] < best["dur"]):
                best = e
        return str(best["name"]) if best is not None else "python (no aten op)"

    gaps: Dict[str, float] = defaultdict(float)
    prev_end = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev_end:
            nxt = first_after.get(a)
            if nxt is None:
                label = "window end (host finishing)"
            else:
                corr = (nxt.get("args") or {}).get("correlation")
                t = launch_ts.get(corr)
                label = (host_op(t) if t is not None else "no launch record") + " -> " + (
                    _short(str(nxt["name"])) if nxt["cat"] == "kernel" else nxt["cat"])
            gaps[label] += (a - prev_end) * 1e-6
        prev_end = max(prev_end, b)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "kernels": {k: [v[0], v[1]] for k, v in kernels.items()},
        "launches": launches,
        "kernel_records": kept,
        "device_ops": sorted(([k, v[0]] for k, v in kernels.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:TOP],
    }


def session(work: Callable[[], object], host_ops: bool = False) -> Tuple[Dict, object]:
    """``(reduction, work's result)`` of one session around ``work()``,
    recording the host ops too with ``host_ops``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        time.sleep(PAD_S)
        torch.cuda.synchronize()
        with record_function(WINDOW) if host_ops else contextlib.nullcontext():
            out = work()
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_trace(events), out


def traced(work: Callable[[], object]) -> Tuple[Dict, object]:
    """The best of up to ``ATTEMPTS`` device sessions, scaled by its kept
    share, with the idle gaps named by one more session that records the
    host ops."""
    best = None
    sessions = 0
    for _ in range(ATTEMPTS):
        red, out = session(work)
        sessions += 1
        share = red["kernel_records"] / red["launches"] if red["launches"] else 1.0
        if best is None or share > best[0]["kept_share"]:
            red["kept_share"] = min(share, 1.0)
            best = (red, out)
        if share >= 1.0:
            break
    red, out = best
    if red["kernel_records"] == 0:
        raise RuntimeError(f"the profiler kept no kernel record in {sessions} sessions")
    scale = 1.0 / red["kept_share"]
    red["kernels"] = {k: [v[0] * scale, v[1] * scale] for k, v in red["kernels"].items()}
    red["busy_s"] = min(red["busy_s"] * scale, red["window_s"])
    named, _ = session(work, host_ops=True)
    red["idle_gaps"] = named["idle_gaps"]
    red["sessions"] = sessions + 1
    return red, out


def steady_seconds(step: Callable[[], object], warm: int, min_seconds: float) -> Tuple[float, int, List[float]]:
    """``(device seconds a call, calls timed, gaps in ms)`` of ``step()`` in
    steady state, with no profiler: ``warm`` calls are queued first, then a
    CUDA event, calls until ``min_seconds`` of host time have passed, each
    followed by an event, and only then a synchronise.  The gaps are those
    between consecutive events, one a call."""
    marks = [torch.cuda.Event(enable_timing=True)]
    for _ in range(warm):
        step()
    marks[0].record()
    t0 = time.perf_counter()
    while len(marks) == 1 or time.perf_counter() - t0 < min_seconds:
        step()
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    marks[-1].synchronize()
    gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return sum(gaps) * 1e-3 / len(gaps), len(gaps), gaps


def kernel_seconds(trace: Dict, *fragments: str) -> float:
    """Device seconds of every kernel whose name holds one of ``fragments``."""
    return sum(v[0] for k, v in trace["kernels"].items() if any(f in k for f in fragments))
