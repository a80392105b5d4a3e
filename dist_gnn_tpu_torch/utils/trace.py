"""Spans and counters inside the program, off by default.

The training step, the sampler, the models' dropout and the full-graph
pass open named spans around their phases (``Trainer.train_step``:
``train_step`` holding ``sample``, ``gather``, ``forward``, ``backward``
and ``optimizer``; ``sampler.blocks_from_hops``: ``sample.draw`` and
``sample.relabel`` per hop; ``models/sage._dropout``: ``forward.dropout``;
``full_graph_inference``: ``infer_pass`` holding ``infer.upload``, and
``infer.edge_walk`` and ``infer.dense`` per layer) and count the frontier's
valid and allotted rows per hop (``sample.frontier_rows``,
``sample.frontier_alloc``) and the elements each dropout layer masks
(``dropout.elems``).

Off, :func:`span` is one flag check that returns a shared no-op context:
it reads no clock, launches nothing and never waits for the card, and
:func:`count` returns at once.  To record::

    from dist_gnn_tpu_torch.utils import trace

    trace.enable()
    for _ in range(steps):
        trainer.train_step(...)
    a0 = trace.anchor()                 # optional: host clock around a synchronize
    spans, counters, dropped = trace.drain()
    trace.disable()
    print(trace.summary(warmup=3, spans=spans))   # mean host ms per span name

Each span record is a dict: ``name``, ``attrs`` (``hop``, ``layer``),
``id``, ``parent`` (the innermost span open on the same thread, or
None), ``root`` (the id of the outermost one, so a step's spans share
it), ``tid`` (``threading.get_native_id()``), ``ident``
(``threading.get_ident()``), ``t0`` and ``t1`` (``time.perf_counter_ns()``
at entry and exit).  Records go into an in-memory list of at most
``CAP``; those beyond it are counted as dropped.  Nothing is written to
disk.

A counter adds ints to a running sum at once, and keeps references to
0-d tensors the program already computed, at most ``CAP`` of them between
drains (those beyond are counted as dropped, as spans are); :func:`drain`
sums them (one read-back per counter), so counting adds no launch and no
read-back to the step.

:func:`anchor` takes ``perf_counter_ns()`` just before and just after one
``torch.cuda.synchronize()``; a reader of a device trace finds that
synchronize's runtime record and maps the spans' host times onto the
trace's clock from two anchors.  The step path never calls it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

CAP = 1 << 17  # span records kept between drains


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "name", "attrs")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.rec._open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.rec._close()
        return False


class Recorder:
    """Span records and counters of one process (the module's functions
    drive one shared instance).  A record is kept as a list until
    :meth:`drain` makes it a dict."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self.spans: List[list] = []
        self.dropped = 0
        self.counters: Dict[str, list] = defaultdict(_counter)  # name -> [int sum, 0-d tensors]
        self.refs = 0  # tensors the counters keep

    def span(self, name: str, **attrs):
        """A context around one phase; off, the shared no-op context."""
        if not self.on:
            return NOOP
        return _Span(self, name, attrs)

    def count(self, name: str, value) -> None:
        """Add ``value`` (an int, or a 0-d tensor kept by reference while
        fewer than ``cap`` are kept) to counter ``name``; off, nothing."""
        if self.on:
            with self._lock:
                c = self.counters[name]
                if not isinstance(value, torch.Tensor):
                    c[0] += int(value)
                elif self.refs < self.cap:
                    c[1].append(value)
                    self.refs += 1
                else:
                    self.dropped += 1

    def _open(self, name: str, attrs: Dict) -> None:
        local = self._local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
            local.thread = (threading.get_native_id(), threading.get_ident())
        sid = next(self._ids)
        parent, root = (stack[-1][2], stack[-1][4]) if stack else (None, sid)
        stack.append([name, attrs, sid, parent, root, local.thread, time.perf_counter_ns(), None])

    def _close(self) -> None:
        t1 = time.perf_counter_ns()
        rec = self._local.stack.pop()
        rec[7] = t1
        if len(self.spans) < self.cap:
            self.spans.append(rec)
        else:
            with self._lock:
                self.dropped += 1

    def drain(self) -> Tuple[List[Dict], Dict[str, int], int]:
        """``(spans in order of exit, counters summed, span records and
        counter tensors dropped)``, and the recorder emptied."""
        with self._lock:
            spans, counters, dropped = self.spans, self.counters, self.dropped
            self.spans, self.counters, self.dropped, self.refs = [], defaultdict(_counter), 0, 0
        sums = {}
        for name, (ints, tensors) in counters.items():
            if tensors:
                ints += int(torch.stack([t.reshape(()).to(tensors[0].device, torch.int64) for t in tensors]).sum())
            sums[name] = ints
        return [_as_dict(r) for r in spans], sums, dropped


def _counter() -> list:
    return [0, []]


def _as_dict(r: list) -> Dict:
    name, attrs, sid, parent, root, (tid, ident), t0, t1 = r
    return {"name": name, "attrs": attrs, "id": sid, "parent": parent, "root": root, "tid": tid, "ident": ident,
            "t0": t0, "t1": t1}


_REC = Recorder()
span = _REC.span
count = _REC.count


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def drain() -> Tuple[List[Dict], Dict[str, int], int]:
    """``(spans, counters summed, records dropped)`` since the last drain;
    the recorder is emptied."""
    return _REC.drain()


def anchor() -> Tuple[int, int]:
    """``perf_counter_ns()`` just before and just after one
    ``torch.cuda.synchronize()``."""
    t0 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return t0, time.perf_counter_ns()


def summary(warmup: int = 0, spans: Optional[List[Dict]] = None) -> Dict[str, float]:
    """Mean host ms per span name over ``spans`` (default: the records not
    yet drained), leaving out each name's first ``warmup`` spans; a name
    with none past the warm-up reports its last one."""
    if spans is None:
        with _REC._lock:
            spans = [_as_dict(r) for r in _REC.spans]
    by_name: Dict[str, List[int]] = defaultdict(list)
    for s in sorted(spans, key=lambda s: s["t0"]):
        by_name[s["name"]].append(s["t1"] - s["t0"])
    out = {}
    for name, ns in by_name.items():
        kept = ns[warmup:] or ns[-1:]
        out[name] = 1e-6 * sum(kept) / len(kept)
    return out
