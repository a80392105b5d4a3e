"""Phase timing and structured metrics.

Counterpart of ``dist_gnn_tpu/utils/metrics.py``:

* :class:`PhaseTimer` accumulates named phases and reports the mean over
  the samples after ``warmup`` (the reference's report drops the first
  iterations); with no sample past the warm-up it reports the last one, not
  an average that holds the first call's build.  ``stop`` takes a fence: a
  CUDA tensor makes it wait for the card first, so a phase times the work
  it queued.
* :class:`MetricsLogger` writes JSON lines to standard output and/or a
  file; ``stdout=True`` writes to ``sys.stdout`` itself.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Optional

from dist_gnn_tpu_torch.utils.timing import device_sync


class PhaseTimer:
    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.samples = defaultdict(list)
        self._t0 = {}

    def start(self, phase: str) -> None:
        self._t0[phase] = time.perf_counter()

    def stop(self, phase: str, fence=None) -> float:
        """End ``phase``; seconds since its ``start``, after waiting for
        ``fence`` (a tensor or a sequence of them) when given."""
        if fence is not None:
            device_sync(fence)
        dt = time.perf_counter() - self._t0.pop(phase)
        self.samples[phase].append(dt)
        return dt

    def mean_ms(self, phase: str) -> float:
        s = self.samples[phase][self.warmup :] or self.samples[phase][-1:]
        return 1000.0 * sum(s) / max(len(s), 1)

    def report(self) -> dict:
        return {p: round(self.mean_ms(p), 3) for p in self.samples}


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout: bool = True):
        self.fh = open(path, "a") if path else None
        self.stdout = stdout

    def log(self, event: str, **fields) -> None:
        line = json.dumps({"event": event, "ts": time.time(), **fields})
        if self.stdout:
            print(line, file=sys.stdout)
        if self.fh:
            self.fh.write(line + "\n")
            self.fh.flush()

    def close(self) -> None:
        if self.fh:
            self.fh.close()
