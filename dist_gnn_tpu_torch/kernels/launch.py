"""What every kernel wrapper of the port shares around a launch: the
argument checks' error, the raw current stream, and the launch's return
code.  Nothing here builds or loads a kernel (``build`` does) or touches
the card at import."""

from __future__ import annotations

import torch


def require(cond: bool, msg: str) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``: a wrapper's argument
    check, made before anything launches."""
    if not cond:
        raise ValueError(msg)


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, which must be the current
    device: the kernels launch there.  Takes the raw forms of
    ``torch.cuda.current_device()`` and ``current_stream().cuda_stream``,
    which a CUDA build of PyTorch has and which skip the lazy-init check and
    building a Stream object (0.2 against 7.7 µs a call, PERF.md)."""
    index = t.get_device()
    if index != torch._C._cuda_getDevice():
        raise ValueError(f"{t.device} is not the current CUDA device")
    return torch._C._cuda_getCurrentRawStream(index)


def check_launch(rc: int, name: str) -> None:
    """Raise unless the C entry point returned 0 (it returns the
    ``cudaError`` of its launch)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
