"""K1 (feature-row gather), K2 (the same gather by double-buffered row
copies) and K3 (masked neighbour mean): wrappers.

Counterpart of ``dist_gnn_tpu/ops/gather_pallas.py`` (``gather_rows``,
``gather_rows_dma`` and ``gather_mean``).  The kernels are CUDA C++ for sm_90a in
``csrc/gather.cu``, whose header notes which Pallas kernel each replaces,
what bounds it on the card and how its design meets that bound.
``gather_mean`` is differentiable: a ``torch.autograd.Function`` whose
backward is a kernel of its own (:func:`gather_mean_bwd`), so the gradient
reaches the layers below on the card as it does on the CPU.

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
        lib.dg_gather_rows_dma.argtypes = [p, p, p, i64, i64, i64, i32, i32, p]
        lib.dg_gather_rows_dma.restype = i32
        lib.dg_smem_optin_bytes.argtypes = [i32]
        lib.dg_smem_optin_bytes.restype = i64
        lib.dg_gather_mean.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, i32, p]
        lib.dg_gather_mean.restype = i32
        lib.dg_gather_mean_bwd.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, p]
        lib.dg_gather_mean_bwd.restype = i32
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
    """Plain version of K1 and of K2: ``table[idx]``."""
    return table[idx.long()]


def _gather_out(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Check K1's and K2's CUDA arguments and return their empty [L, F]
    output; a non-empty output needs a non-empty table."""
    _require(table.is_cuda and idx.device == table.device, "table and idx must share one CUDA device")
    _require(table.dim() == 2 and table.is_contiguous(), "table must be a contiguous [N, F] tensor")
    _require(
        idx.dim() == 1 and idx.dtype == torch.int32 and idx.is_contiguous(),
        "idx must be a contiguous 1-D int32 tensor",
    )
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    _require(out.numel() == 0 or table.shape[0] > 0, "cannot gather from an empty table")
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` — K1 on the card.

    table [N, F] of any F and dtype, idx [L] int32 in [0, N) (the caller
    clips; the kernel clamps so a bad id cannot read outside the table).
    An empty idx returns [0, F] without a launch.  Outputs are exact."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    out = _gather_out(table, idx)
    if out.numel() == 0:
        return out
    N, F = table.shape
    L = idx.shape[0]
    row_bytes = F * table.element_size()
    rc = _lib().dg_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, L, row_bytes,
        _vec_bytes(row_bytes, table, out), _stream(table),
    )
    _check_launch(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


gather_rows_dma_plain = gather_rows_plain  # K2 computes K1's function


def dma_stage_bytes(row_bytes: int, rows_per_step: int) -> int:
    """Shared memory K2 needs per block: two stages of ``rows_per_step``
    rows."""
    return 2 * rows_per_step * row_bytes


def smem_optin_bytes(device: torch.device) -> int:
    """The dynamic shared memory a block may opt in to on a CUDA device
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``; 232448 bytes on an
    H100)."""
    _require(device.type == "cuda", f"{device} has no CUDA shared memory")
    index = torch.cuda.current_device() if device.index is None else device.index
    limit = _lib().dg_smem_optin_bytes(index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of {device}")
    return limit


def gather_rows_dma(table: torch.Tensor, idx: torch.Tensor, rows_per_step: int = 128) -> torch.Tensor:
    """``table[idx]`` — K2 on the card: K1's result through double-buffered
    row copies, ``rows_per_step`` rows per stage and two stages in flight
    per block.

    K1's contract: table [N, F] of any F and dtype, idx [L] int32 in
    [0, N) (the kernel clamps), an empty idx gives [0, F] without a launch,
    outputs are exact.  Raises ``ValueError`` before any launch when
    ``rows_per_step`` < 1, or when the two stages
    (:func:`dma_stage_bytes`) exceed :func:`smem_optin_bytes`."""
    _require(rows_per_step >= 1, f"rows_per_step must be at least 1, got {rows_per_step}")
    if table.device.type == "cpu":
        return gather_rows_dma_plain(table, idx)
    out = _gather_out(table, idx)
    if out.numel() == 0:
        return out
    N, F = table.shape
    L = idx.shape[0]
    row_bytes = F * table.element_size()
    need, limit = dma_stage_bytes(row_bytes, rows_per_step), smem_optin_bytes(table.device)
    _require(
        need <= limit,
        f"rows_per_step={rows_per_step}: two stages of {rows_per_step} x {row_bytes} B rows "
        f"need {need} B of shared memory, above the {limit} B a block may opt in to",
    )
    rc = _lib().dg_gather_rows_dma(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, L, row_bytes,
        _vec_bytes(row_bytes, table, out), rows_per_step, _stream(table),
    )
    _check_launch(rc, "gather_rows_dma")
    gather_rows_dma.launches += 1
    return out


gather_rows_dma.launches = 0


def _check_mean_args(x: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` (h or d_out) and the [S, k] slot table suit K3."""
    _require(
        x.is_cuda and slots.device == x.device and mask.device == x.device,
        f"{name}, slots and mask must share one CUDA device",
    )
    _require(x.dtype in _DTYPE_CODES, f"{name} dtype {x.dtype} is not float32 or bfloat16")
    _require(x.dim() == 2 and x.is_contiguous(), f"{name} must be a contiguous 2-D tensor")
    _require(
        slots.dim() == 2 and slots.dtype == torch.int32 and slots.is_contiguous(),
        "slots must be a contiguous [S, k] int32 tensor",
    )
    _require(
        mask.shape == slots.shape and mask.dtype == torch.bool and mask.is_contiguous(),
        "mask must be a contiguous bool tensor shaped like slots",
    )


def _gather_mean_fwd(h_src: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The forward: the plain version for CPU tensors, K3 for CUDA ones."""
    if h_src.device.type == "cpu":
        return spmm.gather_mean(h_src, slots, mask)
    _check_mean_args(h_src, slots, mask, "h_src")
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


def gather_mean_bwd_plain(
    d_out: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor, cap: int
) -> torch.Tensor:
    """Plain version of the K3 backward (what :func:`gather_mean_bwd` runs
    for CPU tensors): ``d_h[slots[s, j]]
    += d_out[s] / max(cnt_s, 1)`` over valid j, summed in f32 over the
    materialised [S*k, F] repeated rows, then cast to d_out's dtype."""
    S, k = slots.shape
    cnt = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    scaled = d_out.float() / cnt[:, None]  # [S, F]
    rows = scaled[:, None, :].expand(S, k, d_out.shape[1])[mask]  # [valid, F]
    d_h = torch.zeros((cap, d_out.shape[1]), dtype=torch.float32, device=d_out.device)
    d_h.index_add_(0, slots[mask].long(), rows)
    return d_h.to(d_out.dtype)


def gather_mean_bwd(
    d_out: torch.Tensor,  # [S, F] float32 or bfloat16
    slots: torch.Tensor,  # [S, k] int32
    mask: torch.Tensor,  # [S, k] bool
    cap: int,
) -> torch.Tensor:
    """Gradient of :func:`gather_mean` with respect to h_src, [cap, F] in
    d_out's dtype — the K3 backward kernel on the card (plain version:
    :func:`gather_mean_bwd_plain`).

    The kernel adds in f32 with atomics, in no fixed order, and casts once:
    f32 results agree with the plain version to rounding (the card check
    holds them to 1e-4 of the largest magnitude), bf16 to 5e-2."""
    if d_out.device.type == "cpu":
        return gather_mean_bwd_plain(d_out, slots, mask, cap)
    _check_mean_args(d_out, slots, mask, "d_out")
    S, k = slots.shape
    F = d_out.shape[1]
    _require(d_out.shape[0] == S, f"d_out has {d_out.shape[0]} rows, slots {S}")
    d_h = torch.zeros((cap, F), dtype=torch.float32, device=d_out.device)
    if S == 0 or F == 0 or k == 0 or cap == 0:
        return d_h.to(d_out.dtype)
    rc = _lib().dg_gather_mean_bwd(
        d_out.data_ptr(), slots.data_ptr(), mask.data_ptr(), d_h.data_ptr(),
        cap, S, k, F, _DTYPE_CODES[d_out.dtype], _stream(d_out),
    )
    _check_launch(rc, "gather_mean_bwd")
    gather_mean_bwd.launches += 1
    return d_h.to(d_out.dtype)


gather_mean_bwd.launches = 0


class _GatherMean(torch.autograd.Function):
    """K3 forward with the K3 backward as its gradient (slots and mask get
    none)."""

    @staticmethod
    def forward(ctx, h_src, slots, mask):
        ctx.save_for_backward(slots, mask)
        ctx.cap = h_src.shape[0]
        return _gather_mean_fwd(h_src, slots, mask)

    @staticmethod
    def backward(ctx, d_out):
        slots, mask = ctx.saved_tensors
        return gather_mean_bwd(d_out.contiguous(), slots, mask, ctx.cap), None, None


def gather_mean(
    h_src: torch.Tensor,  # [cap, F] float32 or bfloat16
    slots: torch.Tensor,  # [S, k] int32 positions into h_src
    mask: torch.Tensor,  # [S, k] bool
) -> torch.Tensor:
    """Masked neighbour mean per destination row, [S, F] in h's dtype — K3
    on the card (plain version: :func:`spmm.gather_mean`), differentiable
    in h_src through :func:`gather_mean_bwd`.

    Sums in f32 and rounds once, so bf16 results differ from the plain
    version (which rounds the sum and the quotient in bf16) by rounding:
    the card check holds bf16 to rtol 1e-2 and f32 to rtol 1e-5."""
    return _GatherMean.apply(h_src, slots, mask)


gather_mean.launches = 0
