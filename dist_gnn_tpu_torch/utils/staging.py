"""Reusable host buffers for host → device copies.

A :class:`PinnedRing` holds ``depth`` sets of host buffers, pinned when the
target is the card so that ``tensor.to(device, non_blocking=True)`` from
them is an asynchronous DMA.  The caller fills a set while the copies
from the other set are in flight; a set is handed out again only after the
event recorded behind its last copies has passed, so a buffer is never
rewritten while the card still reads it.  Buffers grow to the largest
request and are reused after that.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


class PinnedRing:
    def __init__(self, device: torch.device, depth: int = 2):
        self.pin = device.type == "cuda"
        self._bufs: List[Dict[str, torch.Tensor]] = [{} for _ in range(depth)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * depth
        self._turn = 0

    def acquire(self) -> int:
        """The next set, once the copies last made from it have left."""
        i = self._turn % len(self._bufs)
        self._turn += 1
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        return i

    def buffer(self, i: int, name: str, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        """Set ``i``'s buffer ``name`` as a contiguous tensor of ``shape``."""
        n = 1
        for s in shape:
            n *= int(s)
        buf = self._bufs[i].get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = self._bufs[i][name] = torch.empty(max(n, 1), dtype=dtype, pin_memory=self.pin)
        return buf[:n].view(*shape)

    def release(self, i: int, stream: Optional[torch.cuda.Stream] = None) -> Optional[torch.cuda.Event]:
        """Mark set ``i``'s copies as issued (on ``stream``, default the
        current one): record the event that :meth:`acquire` waits on, and
        return it (None on the CPU, where copies finish in place)."""
        if not self.pin:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        self._events[i] = ev
        return ev
