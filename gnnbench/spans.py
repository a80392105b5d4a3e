"""The program's own spans and counters (``dist_gnn_tpu_torch/utils/trace``)
on the device trace's clock, for the per-layer readers that read them.

The first reader to ask for them (:func:`of`) measures them once for the
traced run's record and keeps the result in it under ``spans``.  The
measurement runs after the driver's traced work, its reference and its
memory reading, in a process of its own (``python -m gnnbench.spans``),
because a process that has run a profiler session issues its steps more
slowly afterwards.  That process builds the cell again through its
driver's own constructor (``TrainCell``, ``InferCell``) from the
configuration and traffic mix the record names, with weights from
``SEED``, and drives the driver's own ``step`` (``one_pass``) and feed.
Every session and stretch of the driver ran with the program's tracing
off.

1. ``PACED`` steps (passes) with tracing on, each issued after a
   synchronize, so from an empty launch queue: the median host time
   inside the root span (``train_step``, ``infer_pass``) is the host's
   own work a step, with no wait on the queue in it.  Over the driver's
   steady step (pass) time it is ``host_issue_pct.*``: under 100% the
   host issues a step faster than the card runs it.
2. One device-only profiler session of the traced run's step (pass)
   count with tracing on, and ``ANCHORS`` anchors
   (:func:`~dist_gnn_tpu_torch.utils.trace.anchor`) in a row before the
   work and as many after it, each on an empty queue (up to
   ``trace.ATTEMPTS`` sessions, the one that kept the largest share of its
   kernel records, scaled by that share as ``trace.traced`` scales).
   :func:`reduce_session` maps span times onto the trace's clock by the
   line through the two ends' median anchor offsets, joins each kernel,
   copy and memset to its launching runtime record by correlation id, and
   gives the launch to the innermost span open on the launching thread at
   that instant, or, when none is (autograd's own thread runs
   ``backward()``), to the innermost one open then on the root's thread.
   A span's device time holds its children's.

A program without the recorder (the ``utils/trace`` module), a run without
a card, or a record of neither driver gives ``None``, and so does every
device-time reading when the two ends' anchor offsets disagree by more
than ``ANCHOR_US``.  A measurement that fails or passes ``TIMEOUT_S``
raises, and so fails the traced run.  The reduction goes to standard error
as one line, ``gnnbench: spans {...}``.
"""

from __future__ import annotations

import bisect
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gnnbench import trace

ROOT = Path(__file__).resolve().parent.parent
SEED = 7  # the rebuilt cell's weights and feed; the work does not depend on them
TIMEOUT_S = 400
PACED = {"train": 20, "infer": 3}  # roots timed after a synchronize each
ANCHOR_US = 50.0
ANCHORS = 3  # anchors taken in a row before the work, and as many after it
SYNC = "cudaDeviceSynchronize"
HOST_CATS = ("cuda_runtime", "cuda_driver")
ROOTS = {"train": "train_step", "infer": "infer_pass"}
STEADY = {"train": "steady_step_s", "infer": "steady_pass_s"}  # the driver's untraced step (pass) time
PHASES = ("sample", "gather", "forward", "backward", "optimizer")


def has_recorder() -> bool:
    try:
        return importlib.util.find_spec("dist_gnn_tpu_torch.utils.trace") is not None
    except ImportError:
        return False


# ---- the reduction ------------------------------------------------------------------------------


def _anchor_line(events: List[Dict], anchors: List[Tuple[int, int]]):
    """``(ns -> trace us, disagreement in us, spread in us)`` from the
    anchors' synchronize records and the host clock around
    them, or None without as many such records.  The first half of
    ``anchors`` was taken before the work, the second half after it.  The
    profiler synchronizes too when it stops, so of the session's
    synchronize records those are taken whose spacing is nearest the
    anchors' on the host clock.  An anchor's offset is the mean of its
    record's start less its host start and its record's end less its host
    end; each end of the work takes the median of its anchors' offsets, the
    line runs through the two, the disagreement is their difference and
    the spread the widest range of offsets within one end."""
    syncs = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                    and e.get("name") == SYNC), key=lambda e: float(e["ts"]))
    if len(anchors) < 2 or len(syncs) < len(anchors):
        return None
    apart = [(b[0] - a[0]) * 1e-3 for a, b in zip(anchors, anchors[1:])]
    chosen = min(itertools.combinations(syncs, len(anchors)),
                 key=lambda c: sum(abs(float(y["ts"]) - float(x["ts"]) - d) for x, y, d in zip(c, c[1:], apart)))
    mids, offs = [], []
    for e, (h0, h1) in zip(chosen, anchors):
        ts, dur = float(e["ts"]), float(e["dur"])
        mids.append(0.5 * (h0 + h1))
        offs.append(0.5 * ((ts - h0 * 1e-3) + (ts + dur - h1 * 1e-3)))
    half = len(anchors) // 2
    m0, m1 = statistics.median(mids[:half]), statistics.median(mids[half:])
    o0, o1 = statistics.median(offs[:half]), statistics.median(offs[half:])
    slope = (o1 - o0) / (m1 - m0) if m1 != m0 else 0.0

    def to_trace(ns: float) -> float:
        return ns * 1e-3 + o0 + slope * (ns - m0)

    spread = max(max(part) - min(part) for part in (offs[:half], offs[half:]))
    return to_trace, abs(o1 - o0), spread


def _thread_keys(s: Dict) -> set:
    """The ids a trace may give a span's thread: its native id, its
    ``threading.get_ident()`` (``pthread_self``), and that id's low 32
    bits, which the trace writes as their magnitude as a signed int."""
    low = (s.get("ident") or 0) & 0xFFFFFFFF
    return {s["tid"], s.get("ident"), low, (1 << 32) - low if low >= 1 << 31 else low} - {None, 0}


class _Threads:
    """Per thread, its spans on the trace's clock sorted by start, for the
    innermost one open at an instant."""

    def __init__(self, spans: List[Dict], to_trace: Callable[[float], float]):
        self.by_thread: Dict[int, List[Tuple[float, float, Dict]]] = defaultdict(list)
        for s in spans:
            iv = (to_trace(s["t0"]), to_trace(s["t1"]), s)
            for key in _thread_keys(s):
                self.by_thread[key].append(iv)
        for v in self.by_thread.values():
            v.sort(key=lambda x: x[0])
        self.starts = {t: [x[0] for x in v] for t, v in self.by_thread.items()}

    def innermost(self, tid, ts: float) -> Optional[Dict]:
        ivs = self.by_thread.get(tid)
        if not ivs:
            return None
        i = bisect.bisect_right(self.starts[tid], ts)
        for a, b, s in reversed(ivs[:i]):  # the latest start still open holds the others
            if b >= ts:
                return s
        return None


def reduce_session(events: List[Dict], spans: List[Dict], anchors, root: str) -> Dict:
    """Device seconds by span of one session's chrome-trace events (times
    in us) and the spans recorded in it (``utils/trace`` records, host ns);
    ``anchors`` the host clock around each anchor's synchronize.

    Returns ``roots`` (root spans named ``root``), ``anchor_us`` and
    ``anchor_spread_us`` (:func:`_anchor_line`'s disagreement and
    spread), ``device_s`` by span name, holding children (None when the
    disagreement passes ``ANCHOR_US``), ``outside_s`` (launched outside
    any root span), ``session_s`` (all device time), ``launches`` and
    ``kernel_records``."""
    line = _anchor_line(events, anchors)
    roots = [s for s in spans if s["name"] == root]
    host = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                host[corr] = e
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS]
    launches = sum(1 for e in host.values() if str(e.get("name", "")).startswith(trace.LAUNCH_CALLS))
    out = {"roots": len(roots), "anchor_us": None, "device_s": None, "outside_s": None,
           "session_s": sum(float(e["dur"]) for e in dev) * 1e-6, "launches": launches,
           "kernel_records": sum(e["cat"] == "kernel" for e in dev)}
    if line is None:
        return out
    to_trace, disagree, spread = line
    out.update(anchor_us=disagree, anchor_spread_us=spread)
    if disagree > ANCHOR_US:
        return out
    threads = _Threads(spans, to_trace)
    by_id = {s["id"]: s for s in spans}
    root_tids = {s["tid"] for s in roots}

    def owner(e: Dict) -> Optional[Dict]:
        launch = host.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            return None
        ts = float(launch["ts"])
        s = threads.innermost(launch.get("tid"), ts)
        for tid in root_tids:
            s = s or threads.innermost(tid, ts)
        return s

    by_name: Dict[str, float] = defaultdict(float, {s["name"]: 0.0 for s in spans})
    outside = 0.0
    for e in dev:
        s = owner(e)
        d = float(e["dur"]) * 1e-6
        if s is None or by_id.get(s["root"], {}).get("name") != root:
            outside += d
        while s is not None:
            by_name[s["name"]] += d
            s = by_id.get(s["parent"])
    out.update(device_s=dict(by_name), outside_s=outside)
    return out


# ---- the measurement ----------------------------------------------------------------------------


def _session(work: Callable[[], object]):
    """``(chrome-trace events, spans, counters, anchors)`` of one
    device-only profiler session around ``work()`` with tracing on,
    ``ANCHORS`` anchors in a row before it and as many after it.  Each
    anchor's synchronize finds the queue empty, so its record starts and
    ends with the host's call: a stream synchronize (a record of another
    name) drains the queue first."""
    from torch.profiler import ProfilerActivity, profile

    from dist_gnn_tpu_torch.utils import trace as ptrace

    ptrace.drain()
    anchors = []
    stream = torch.cuda.current_stream()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(trace.PAD_S)
        stream.synchronize()
        anchors += [ptrace.anchor() for _ in range(ANCHORS)]
        ptrace.enable()
        try:
            work()
        finally:
            ptrace.disable()
        stream.synchronize()
        anchors += [ptrace.anchor() for _ in range(ANCHORS)]
        time.sleep(trace.PAD_S)
    spans, counters, _ = ptrace.drain()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events, spans, counters, anchors


def paced_host_s(step: Callable[[], object], root: str, n: int) -> float:
    """Median host seconds inside the root span ``root`` over ``n`` calls
    of ``step()`` with tracing on, each issued after a synchronize."""
    from dist_gnn_tpu_torch.utils import trace as ptrace

    ptrace.drain()
    ptrace.enable()
    try:
        for _ in range(n):
            torch.cuda.synchronize()
            step()
    finally:
        ptrace.disable()
        torch.cuda.synchronize()
    spans, _, _ = ptrace.drain()
    return statistics.median((s["t1"] - s["t0"]) * 1e-9 for s in spans if s["name"] == root)


def cell_of(job: Dict, device: torch.device) -> Tuple[Callable[[], object], int]:
    """``(one step or pass, warm-up calls)`` of ``job``'s cell, built by
    its driver's own constructor with its program; a rebuilt training cell
    must reach the traced run's hop sizes (its frontier caps before the
    dedup-free last hop)."""
    if job["kind"] == "train":
        from gnnbench.drivers.train import TrainCell

        cell = TrainCell(job["cfg"], job["traffic"], SEED, device)
        if list(cell.hops) != job["hops"]:
            raise RuntimeError(f"the rebuilt cell's hop sizes {list(cell.hops)} are not the traced run's "
                               f"{job['hops']}")
        cell.build_program()
        return cell.step, 3
    from gnnbench.drivers.infer_full import InferCell

    cell = InferCell(job["cfg"], job["traffic"], SEED, device)
    cell.build_program()
    return cell.one_pass, 1


def measure(job: Dict) -> Dict:
    """The spans of one cell, in a process of its own: ``job`` holds
    ``kind`` (``train`` or ``infer``), the configuration ``cfg``, the
    traffic mix ``traffic``, ``n`` (steps or passes a session), and for
    training the traced run's ``hops`` (seeds a hop, sampling order)."""
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    kind, n = job["kind"], int(job["n"])
    root = ROOTS[kind]
    step, warm = cell_of(job, device)
    for _ in range(warm):
        step()
    paced = paced_host_s(step, root, PACED[kind])

    def work():
        for _ in range(n):
            step()

    best = None
    for attempt in range(trace.ATTEMPTS):
        events, spans, counters, anchors = _session(work)
        red = reduce_session(events, spans, anchors, root)
        red["kept_share"] = min(1.0, red["kernel_records"] / red["launches"]) if red["launches"] else 1.0
        red["counters"] = counters
        red["sessions"] = attempt + 1
        if best is None or red["kept_share"] > best["kept_share"]:
            best = red
        if red["kept_share"] >= 1.0:
            break
    scale = 1.0 / best["kept_share"] if best["kept_share"] > 0 else 0.0
    if best["device_s"] is not None:
        best["device_s"] = {k: v * scale for k, v in best["device_s"].items()}
        best["outside_s"] *= scale
    best["session_s"] *= scale
    best.update(kind=kind, root=root, paced_host_s=paced, measure_s=time.perf_counter() - t0)
    if best["device_s"] is not None and kind == "train" and best["device_s"].get(root):
        best["phase_share"] = sum(best["device_s"].get(p, 0.0) for p in PHASES) / best["device_s"][root]
    return best


def job_of(record: Dict) -> Optional[Dict]:
    """What :func:`measure` needs of a traced run's record, or None for a
    record of neither driver.  The training traffic mix is the one the
    train driver runs: the record's fanout and batch, without replacement,
    with a dedup-free last hop (it refuses any other).  A pass keeps no
    sampled rows here, so the inference mix samples one."""
    if "cfg" not in record:
        return None
    if "steps" in record and record.get("blocks"):
        blocks = list(reversed(record["blocks"][0]))  # sampling order
        traffic = {"fanout": list(record["fanout"]), "batch_per_rank": int(blocks[0].seeds.shape[0]),
                   "replace": False, "dedup_last": False}
        return {"kind": "train", "cfg": record["cfg"], "traffic": traffic, "n": int(record["steps"]),
                "hops": [int(b.seeds.shape[0]) for b in blocks]}
    if "passes" in record:
        return {"kind": "infer", "cfg": record["cfg"], "traffic": {"sample_rows": 1}, "n": int(record["passes"])}
    return None


def of(record: Dict) -> Optional[Dict]:
    """The spans of ``record``'s cell, measured at the first call (in a
    process of its own, which no profiler session has touched) and kept in
    the record; None where there is nothing to measure.  A measurement
    that fails raises."""
    if "spans" not in record:
        job = job_of(record)
        record["spans"] = None
        if job is not None and torch.cuda.is_available() and has_recorder():
            torch.cuda.empty_cache()
            try:
                out = subprocess.run([sys.executable, "-m", "gnnbench.spans"], input=json.dumps(job), text=True,
                                     stdout=subprocess.PIPE, cwd=ROOT, timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"the spans measurement passed {TIMEOUT_S} s") from None
            lines = out.stdout.strip().splitlines()
            if out.returncode != 0 or not lines:
                raise RuntimeError(f"the spans measurement failed (exit {out.returncode})")
            record["spans"] = json.loads(lines[-1])
            print("gnnbench: spans " + json.dumps(record["spans"]), file=sys.stderr, flush=True)
    return record["spans"]


# ---- what the readers take ----------------------------------------------------------------------


def device_ms(record: Dict, kind: str, name: str) -> Optional[float]:
    """Device ms a root launched inside span ``name``."""
    sp = of(record)
    if sp is None or sp["kind"] != kind or sp["device_s"] is None or not sp["roots"]:
        return None
    if name not in sp["device_s"]:
        return None
    return 1e3 * sp["device_s"][name] / sp["roots"]


def host_issue_pct(record: Dict, kind: str) -> Optional[float]:
    """Host time inside the root span of a step (pass) issued from an empty
    queue over the driver's steady step (pass) time, in %."""
    sp = of(record)
    if sp is None or sp["kind"] != kind or not record.get(STEADY[kind]):
        return None
    return 100.0 * sp["paced_host_s"] / record[STEADY[kind]]


def counter_share_pct(record: Dict, kind: str, part: str, whole: str) -> Optional[float]:
    sp = of(record)
    if sp is None or sp["kind"] != kind or not sp["counters"].get(whole):
        return None
    return 100.0 * sp["counters"].get(part, 0) / sp["counters"][whole]


if __name__ == "__main__":
    print(json.dumps(measure(json.loads(sys.stdin.read()))), flush=True)
