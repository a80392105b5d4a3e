"""K1 (feature-row gather) and K3 (masked neighbour mean): wrappers.

Counterpart of ``dist_gnn_tpu/ops/gather_pallas.py`` (``gather_rows`` and
``gather_mean``).  The kernels are CUDA C++ for sm_90a in
``csrc/gather.cu``, whose header notes which Pallas kernel each replaces,
what bounds it on the card and how its design meets that bound.

Each wrapper takes its plain PyTorch version for CPU tensors and only for
them.  A CUDA tensor launches the kernel, or raises: there is no fallback.
Each wrapper counts its launches in a plain int attribute, ``.launches``,
which only a launch increments, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.ops import spmm

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("gather")
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.dg_gather_rows.argtypes = [p, p, p, i64, i64, i64, i32, p]
        lib.dg_gather_rows.restype = i32
        lib.dg_gather_mean.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, i32, p]
        lib.dg_gather_mean.restype = i32
        lib._argtypes_set = True
    return lib


def _vec_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest vector (16, 8, 4, 2 or 1 bytes) that divides the row and
    the base address of every tensor, so no vector load is misaligned."""
    vec = 16
    while vec > 1 and (row_bytes % vec or any(t.data_ptr() % vec for t in tensors)):
        vec //= 2
    return vec


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, which must be the current
    device: the kernels launch there."""
    _require(
        t.device.index in (None, torch.cuda.current_device()),
        f"{t.device} is not the current CUDA device",
    )
    return torch.cuda.current_stream().cuda_stream


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``table[idx]``."""
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` — K1 on the card.

    table [N, F] of any F and dtype, idx [L] int32 in [0, N) (the caller
    clips; the kernel clamps so a bad id cannot read outside the table).
    An empty idx returns [0, F] without a launch.  Outputs are exact."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _require(table.is_cuda and idx.device == table.device, "table and idx must share one CUDA device")
    _require(table.dim() == 2 and table.is_contiguous(), "table must be a contiguous [N, F] tensor")
    _require(
        idx.dim() == 1 and idx.dtype == torch.int32 and idx.is_contiguous(),
        "idx must be a contiguous 1-D int32 tensor",
    )
    N, F = table.shape
    L = idx.shape[0]
    out = torch.empty((L, F), dtype=table.dtype, device=table.device)
    if L == 0 or F == 0:
        return out
    _require(N > 0, "cannot gather from an empty table")
    row_bytes = F * table.element_size()
    rc = _lib().dg_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, L, row_bytes,
        _vec_bytes(row_bytes, table, out), _stream(table),
    )
    _check_launch(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_mean(
    h_src: torch.Tensor,  # [cap, F] float32 or bfloat16
    slots: torch.Tensor,  # [S, k] int32 positions into h_src
    mask: torch.Tensor,  # [S, k] bool
) -> torch.Tensor:
    """Masked neighbour mean per destination row, [S, F] in h's dtype — K3
    on the card (plain version: :func:`spmm.gather_mean`).

    Sums in f32 and rounds once, so bf16 results differ from the plain
    version (which rounds the sum and the quotient in bf16) by rounding:
    the card check holds bf16 to rtol 1e-2 and f32 to rtol 1e-5."""
    if h_src.device.type == "cpu":
        return spmm.gather_mean(h_src, slots, mask)
    _require(
        h_src.is_cuda and slots.device == h_src.device and mask.device == h_src.device,
        "h_src, slots and mask must share one CUDA device",
    )
    _require(h_src.dtype in _DTYPE_CODES, f"h_src dtype {h_src.dtype} is not float32 or bfloat16")
    _require(h_src.dim() == 2 and h_src.is_contiguous(), "h_src must be a contiguous [cap, F] tensor")
    _require(
        slots.dim() == 2 and slots.dtype == torch.int32 and slots.is_contiguous(),
        "slots must be a contiguous [S, k] int32 tensor",
    )
    _require(
        mask.shape == slots.shape and mask.dtype == torch.bool and mask.is_contiguous(),
        "mask must be a contiguous bool tensor shaped like slots",
    )
    cap, F = h_src.shape
    S, k = slots.shape
    if S == 0 or F == 0 or k == 0 or cap == 0:
        # nothing to average: every row is empty (cap == 0 leaves no row a
        # valid slot could name)
        return torch.zeros((S, F), dtype=h_src.dtype, device=h_src.device)
    out = torch.empty((S, F), dtype=h_src.dtype, device=h_src.device)
    rc = _lib().dg_gather_mean(
        h_src.data_ptr(), slots.data_ptr(), mask.data_ptr(), out.data_ptr(),
        cap, S, k, F, _DTYPE_CODES[h_src.dtype],
        _vec_bytes(F * h_src.element_size(), h_src, out), _stream(h_src),
    )
    _check_launch(rc, "gather_mean")
    gather_mean.launches += 1
    return out


gather_mean.launches = 0
