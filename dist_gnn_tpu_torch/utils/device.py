"""The port's device rule: CUDA unless the caller asks for the CPU.

Every entry point that places state on a device resolves its ``device``
argument here.  ``None`` means the card; only an explicit ``"cpu"`` gives
the CPU.  With no card, the default raises instead of falling back, so a
run that was meant for the GPU can never quietly measure the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` for ``None``; the given device otherwise.  Raises when a
    CUDA device is asked for (explicitly or by default) and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

