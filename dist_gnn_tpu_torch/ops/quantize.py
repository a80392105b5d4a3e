"""Int8 row quantization for the feature stores.

Counterpart of ``dist_gnn_tpu/ops/quantize.py``: symmetric per-row int8
quantization stores a row in ``F + 4`` bytes instead of ``4F``, so a hot
tier of the same bytes holds about four times the rows, and an exchange
moves a quarter of the bytes.

Rows are stored *packed*: ``[N, F+4]`` int8, the last 4 bytes the row's
f32 scale, bit for bit.  A packed row rides every gather (K1 takes rows of
any width) and exchange unchanged and is dequantized once by its consumer.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_pack(features: np.ndarray) -> np.ndarray:
    """[N, F] float → [N, F+4] int8 (values, then the f32 scale's bytes).
    The same arithmetic as the JAX package's, so the bytes are equal."""
    f = np.asarray(features, np.float32)
    absmax = np.maximum(np.abs(f).max(axis=1), 1e-12)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.rint(f / scale[:, None]), -127, 127).astype(np.int8)
    scale_bytes = scale.reshape(-1, 1).view(np.int8)  # [N, 4]
    return np.concatenate([q, scale_bytes], axis=1)


def dequantize_unpack(packed: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[*, F+4] int8 → [*, F]: the last 4 bytes viewed as the f32 scale,
    times the values in f32, then cast to ``out_dtype``."""
    scale = packed[..., -4:].contiguous().view(torch.float32)  # [*, 1]
    return (packed[..., :-4].to(torch.float32) * scale).to(out_dtype)
