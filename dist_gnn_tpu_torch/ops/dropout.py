"""Inverted dropout with one uint32 key per row: K10 (``csrc/sampling.cu``
``dg_dropout``).

An element (r, c) of an [S, H] activation is kept where ``prng.dropout_keep``
keeps it (``mix32(key_r ^ c * 0x9E3779B9)``'s uniform below ``1 - rate``)
and scaled by ``1 / (1 - rate)``; a dropped element is 0.  K10 hashes the
mask in registers and writes the output in one pass over h, in h's dtype
(float32 or bfloat16).  The card's ``h / (1 - rate)`` multiplies by the f32
reciprocal of ``(float)(1 - rate)``, and K10 does the same, so its output
equals :func:`dropout_plain`'s on the card bit for bit.  With its mask
fixed, dropout is linear and its own transpose: the backward is K10 on the
gradient with the same keys, and only the [S] keys are saved.

:func:`dropout` takes :func:`dropout_plain` for CPU tensors and only for
them; a CUDA tensor launches K10 or raises.  A call takes at most
``MAX_ELEMS`` elements.  Each launch, forward or backward, adds one to
``dropout.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.kernels.launch import check_launch, require, stream_of
from dist_gnn_tpu_torch.ops import prng

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16  # csrc/sampling.cu: the vector kernel's load, one thread each
MAX_ELEMS = 1 << 31  # csrc/sampling.cu kMaxDropoutElems: K10's indices are 32-bit


def _lib() -> ctypes.CDLL:
    lib = build.load("sampling")
    if not getattr(lib, "_dropout_argtypes_set", False):
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.dg_dropout.argtypes = [p, p, p, i64, i64, i32, i32, f32, f32, p]
        lib.dg_dropout.restype = i32
        lib._dropout_argtypes_set = True
    return lib


def dropout_plain(h: torch.Tensor, row_keys: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain version of K10: the int64 mask of ``prng.dropout_keep``, then
    ``where(keep, h / (1 - rate), 0)``; autograd differentiates it."""
    keep = prng.dropout_keep(row_keys, h.shape, 1.0 - rate)
    return torch.where(keep, h / (1.0 - rate), 0)


def vector_width(H: int, dtype: torch.dtype, *ptrs: int) -> int:
    """Elements a K10 thread takes: a 16-byte vector where a row is whole
    vectors and every pointer is 16-byte aligned, else 1."""
    if (H * dtype.itemsize) % VEC_BYTES == 0 and all(p % VEC_BYTES == 0 for p in ptrs):
        return VEC_BYTES // dtype.itemsize
    return 1


def _check_layout(h: torch.Tensor, row_keys: torch.Tensor, rate: float) -> Tuple[int, int]:
    """``(S, H)`` of a launch's inputs, or ``ValueError``."""
    require(h.dtype in _DTYPE_CODES, f"dtype {h.dtype} is not float32 or bfloat16")
    require(h.dim() == 2 and h.is_contiguous(), "h must be a contiguous [S, H] tensor")
    S, H = h.shape
    require(S * H <= MAX_ELEMS, f"{S} x {H} elements are more than K10 takes in a call ({MAX_ELEMS})")
    require(row_keys.shape == (S,), f"need {S} row keys, got shape {tuple(row_keys.shape)}")
    require(row_keys.dtype == torch.int64 and row_keys.is_contiguous(),
            "row_keys must be a contiguous int64 tensor")
    require(0.0 <= rate < 1.0, f"rate {rate} is outside [0, 1)")
    return S, H


def _check(h: torch.Tensor, row_keys: torch.Tensor, rate: float) -> Tuple[int, int]:
    require(h.is_cuda and row_keys.device == h.device, "h and row_keys must share one CUDA device")
    return _check_layout(h, row_keys, rate)


def _launch(h: torch.Tensor, row_keys: torch.Tensor, rate: float) -> torch.Tensor:
    """One K10 launch over h [S, H] (or its gradient); none for an empty h."""
    S, H = _check(h, row_keys, rate)
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    keep = np.float32(1.0 - rate)
    scale = np.float32(1.0) / keep
    vec = vector_width(H, h.dtype, h.data_ptr(), out.data_ptr())
    rc = _lib().dg_dropout(h.data_ptr(), row_keys.data_ptr(), out.data_ptr(), S, H, _DTYPE_CODES[h.dtype],
                           vec, float(keep), float(scale), stream_of(h))
    check_launch(rc, "dropout")
    dropout.launches += 1
    return out


class _Dropout(torch.autograd.Function):
    """K10 forward; backward K10 on the gradient with the saved keys."""

    @staticmethod
    def forward(ctx, h, row_keys, rate):
        ctx.save_for_backward(row_keys)
        ctx.rate = rate
        return _launch(h, row_keys, rate)

    @staticmethod
    def backward(ctx, g):
        (row_keys,) = ctx.saved_tensors
        return _launch(g.contiguous(), row_keys, ctx.rate), None, None


def dropout(h: torch.Tensor, row_keys: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of h [S, H] at ``rate`` with one key per row (plain
    version: :func:`dropout_plain`)."""
    if h.device.type == "cpu":
        return dropout_plain(h, row_keys, rate)
    return _Dropout.apply(h, row_keys, rate)


dropout.launches = 0
