"""Structured metrics: :class:`MetricsLogger` writes JSON lines to
standard output and/or a file; ``stdout=True`` writes to ``sys.stdout``
itself.  Counterpart of ``dist_gnn_tpu/utils/metrics.py``'s logger; the
port's phase spans are ``utils/trace``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


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
