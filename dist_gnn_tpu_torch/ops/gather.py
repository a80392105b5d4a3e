"""K1 (feature-row gather), K2 (the same gather by double-buffered row
copies), K3 (masked neighbour mean) and K3-csr (the full-graph neighbour
mean or sum over a CSC): wrappers.

Counterpart of ``dist_gnn_tpu/ops/gather_pallas.py`` (``gather_rows``,
``gather_rows_dma`` and ``gather_mean``).  The kernels are CUDA C++ for sm_90a in
``csrc/gather.cu``, whose header notes which Pallas kernel each replaces,
what bounds it on the card and how its design meets that bound.
``gather_mean`` is differentiable: a ``torch.autograd.Function`` whose
forward also builds the slot table's transpose (:func:`slot_transpose`)
and whose backward is a kernel of its own (:func:`gather_mean_bwd`), so the
gradient reaches the layers below on the card as it does on the CPU.

K3's launch path is kept short, since at the small layers the host's work
per call, not the card's, sets the time: slots and mask are checked once
per block (the backward reuses the forward's check), a call with no
gradient to track skips the autograd node, and the kernels pick their own
vector width from the addresses.

Each wrapper takes its plain PyTorch version for CPU tensors and only for
them.  A CUDA tensor launches the kernel, or raises: there is no fallback.
Each wrapper counts its launches in a plain int attribute, ``.launches``,
which only a launch increments, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.kernels.launch import check_launch, require, stream_of
from dist_gnn_tpu_torch.ops import spmm

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("gather")
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.dg_gather_rows.argtypes = [p, p, p, i64, i64, i64, p]
        lib.dg_gather_rows.restype = i32
        lib.dg_gather_rows_dma.argtypes = [p, p, p, i64, i64, i64, i32, i32, p]
        lib.dg_gather_rows_dma.restype = i32
        lib.dg_smem_optin_bytes.argtypes = [i32]
        lib.dg_smem_optin_bytes.restype = i64
        lib.dg_gather_mean.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, p, p]
        lib.dg_gather_mean.restype = i32
        lib.dg_slot_transpose.argtypes = [p, p, i64, i64, i32, p, p]
        lib.dg_slot_transpose.restype = i32
        lib.dg_gather_mean_bwd.argtypes = [p, p, p, i64, i64, i32, i32, i32, p]
        lib.dg_gather_mean_bwd.restype = i32
        lib.dg_csr_light_max.argtypes = []
        lib.dg_csr_light_max.restype = i32
        lib.dg_csr_plan.argtypes = [p, i64, i64, p, p, p]
        lib.dg_csr_plan.restype = i32
        lib.dg_gather_mean_csr.argtypes = [p, p, p, p, p, p, i64, i64, i64, i32, i32, i32, p]
        lib.dg_gather_mean_csr.restype = i32
        if lib.dg_csr_light_max() != CSR_LIGHT_MAX:
            raise RuntimeError(f"csrc/gather.cu's light limit {lib.dg_csr_light_max()} is not {CSR_LIGHT_MAX}")
        lib._argtypes_set = True
    return lib


def _vec_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest vector (16, 8, 4, 2 or 1 bytes) that divides the row and
    the base address of every tensor, so no vector load is misaligned."""
    vec = 16
    while vec > 1 and (row_bytes % vec or any(t.data_ptr() % vec for t in tensors)):
        vec //= 2
    return vec


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 and of K2: ``table[idx]``."""
    return table[idx.long()]


def _gather_out(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Check K1's and K2's CUDA arguments and return their empty [L, F]
    output; a non-empty output needs a non-empty table."""
    require(table.is_cuda and idx.device == table.device, "table and idx must share one CUDA device")
    require(table.dim() == 2 and table.is_contiguous(), "table must be a contiguous [N, F] tensor")
    require(
        idx.dim() == 1 and idx.dtype == torch.int32 and idx.is_contiguous(),
        "idx must be a contiguous 1-D int32 tensor",
    )
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    require(out.numel() == 0 or table.shape[0] > 0, "cannot gather from an empty table")
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` — K1 on the card.

    table [N, F] of any F and dtype, idx [L] int32 in [0, N) (the caller
    clips; the kernel clamps so a bad id cannot read outside the table).
    An empty idx returns [0, F] without a launch.  Outputs are exact.  The
    kernel picks its load and store widths from F and the addresses."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    out = _gather_out(table, idx)
    if out.numel() == 0:
        return out
    N, F = table.shape
    rc = _lib().dg_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, idx.shape[0], F * table.element_size(),
        stream_of(table),
    )
    check_launch(rc, "gather_rows")
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
    require(device.type == "cuda", f"{device} has no CUDA shared memory")
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
    require(rows_per_step >= 1, f"rows_per_step must be at least 1, got {rows_per_step}")
    if table.device.type == "cpu":
        return gather_rows_dma_plain(table, idx)
    out = _gather_out(table, idx)
    if out.numel() == 0:
        return out
    N, F = table.shape
    L = idx.shape[0]
    row_bytes = F * table.element_size()
    need, limit = dma_stage_bytes(row_bytes, rows_per_step), smem_optin_bytes(table.device)
    require(
        need <= limit,
        f"rows_per_step={rows_per_step}: two stages of {rows_per_step} x {row_bytes} B rows "
        f"need {need} B of shared memory, above the {limit} B a block may opt in to",
    )
    rc = _lib().dg_gather_rows_dma(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, L, row_bytes,
        _vec_bytes(row_bytes, table, out), rows_per_step, stream_of(table),
    )
    check_launch(rc, "gather_rows_dma")
    gather_rows_dma.launches += 1
    return out


gather_rows_dma.launches = 0


def _check_rows(x: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` unless ``x`` (h or d_out, which the caller has
    found on a CUDA device) is a contiguous 2-D float32 or bfloat16 tensor."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} dtype {x.dtype} is not float32 or bfloat16")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")


def _check_slots(slots: torch.Tensor, mask: torch.Tensor, index: int) -> None:
    """Raise ``ValueError`` unless the [S, k] slot table lies on CUDA device
    ``index`` as a contiguous int32 ``slots`` and a bool ``mask`` of its
    shape.  With :func:`_check_rows` these are the checks that keep K3's
    kernels inside their allocations (the kernels clamp each slot into the
    table).  Device indices are compared as ints: a CPU or meta tensor has
    index -1."""
    if slots.get_device() != index or mask.get_device() != index:
        raise ValueError(f"slots and mask must lie on CUDA device {index}")
    require(
        slots.dtype == torch.int32 and slots.dim() == 2 and slots.is_contiguous(),
        "slots must be a contiguous [S, k] int32 tensor",
    )
    require(
        mask.dtype == torch.bool and mask.shape == slots.shape and mask.is_contiguous(),
        "mask must be a contiguous bool tensor shaped like slots",
    )


def _needs_grad(h: torch.Tensor) -> bool:
    return h.requires_grad and torch.is_grad_enabled()


def _launch_gather_mean(
    h_src: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor, ws: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K3 on checked CUDA arguments; with ``ws`` (from
    :func:`_new_ws`) the same C call then builds the slot table's
    transpose into it, as :func:`slot_transpose` does."""
    cap, F = h_src.shape
    S, k = slots.shape
    if S == 0 or F == 0 or k == 0 or cap == 0:
        # nothing to average: every row is empty (cap == 0 leaves no row a
        # valid slot could name)
        if ws is not None:
            _build_transpose(slots, mask, cap, ws)
        return h_src.new_zeros((S, F))
    out = h_src.new_empty((S, F))
    rc = _lib().dg_gather_mean(
        h_src.data_ptr(), slots.data_ptr(), mask.data_ptr(), out.data_ptr(),
        cap, S, k, F, _DTYPE_CODES[h_src.dtype], None if ws is None else ws.data_ptr(), stream_of(h_src),
    )
    check_launch(rc, "gather_mean")
    gather_mean.launches += 1
    if ws is not None:
        slot_transpose.launches += 1
    return out


class SlotTranspose(NamedTuple):
    """The transpose of an [S, k] slot table: source row r's valid slots
    are the flat indices ``s*k + j`` in ``entries[offsets[r]:offsets[r+1]]``.
    ``offsets`` is [cap + 1] int32; ``entries`` is [S*k] int32, of which
    the first ``offsets[cap]`` count (the rest is unspecified)."""

    offsets: torch.Tensor
    entries: torch.Tensor


def _transpose_view(ws: torch.Tensor, cap: int, n_slots: int) -> SlotTranspose:
    """The offsets and entries of a transpose workspace built for ``cap``
    rows from a slot table of ``n_slots`` entries."""
    return SlotTranspose(ws[: cap + 1], ws[cap + 1 : cap + 1 + n_slots])


def slot_transpose_plain(slots: torch.Tensor, mask: torch.Tensor, cap: int) -> SlotTranspose:
    """Plain version of the slot transpose: each list in increasing flat
    index, the unused tail of ``entries`` -1.  Slots are clamped into
    [0, cap) as the kernels clamp them."""
    S, k = slots.shape
    flat = torch.nonzero(mask.reshape(-1)).reshape(-1)  # increasing
    rows = torch.clamp(slots.reshape(-1)[flat].long(), 0, max(cap - 1, 0))
    order = torch.argsort(rows, stable=True)
    offsets = torch.zeros(cap + 1, dtype=torch.int32, device=slots.device)
    offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=cap), 0)
    entries = torch.full((S * k,), -1, dtype=torch.int32, device=slots.device)
    entries[: flat.numel()] = flat[order].to(torch.int32)
    return SlotTranspose(offsets, entries)


def _new_ws(slots: torch.Tensor, cap: int) -> torch.Tensor:
    """An int32 workspace for the transpose of ``slots`` into ``cap`` rows,
    as ``dg_slot_transpose`` lays it out: offsets [cap + 1], entries [S*k],
    their rows' divisors [S*k], each row's divisor [S], then the kernels'
    scratch."""
    S, k = slots.shape
    require(S * k < 2**31, "the slot table exceeds the transpose's int32 indices")
    return slots.new_empty(cap + 1 + 2 * S * k + S + 4 * (cap + 1))


def _build_transpose(slots: torch.Tensor, mask: torch.Tensor, cap: int, ws: torch.Tensor) -> torch.Tensor:
    """Build the slot table's transpose into ``ws`` (checked arguments)."""
    if cap == 0:
        ws.zero_()
        return ws
    S, k = slots.shape
    rc = _lib().dg_slot_transpose(slots.data_ptr(), mask.data_ptr(), cap, S, k, ws.data_ptr(), stream_of(slots))
    check_launch(rc, "slot_transpose")
    slot_transpose.launches += 1
    return ws


def slot_transpose(slots: torch.Tensor, mask: torch.Tensor, cap: int) -> SlotTranspose:
    """The transpose of an [S, k] slot table into ``cap`` source rows, which
    K3's backward reads — on the card four kernels (zero, count, scan,
    fill) chained by programmatic dependent launch, with no memset; plain
    version :func:`slot_transpose_plain`.  On the card a list's order is the
    atomics' (the backward puts it in order as it reads); offsets equal the
    plain version's."""
    if slots.device.type == "cpu":
        return slot_transpose_plain(slots, mask, cap)
    require(slots.is_cuda, "slots must lie on a CUDA device")
    _check_slots(slots, mask, slots.get_device())
    return _transpose_view(_build_transpose(slots, mask, cap, _new_ws(slots, cap)), cap, slots.numel())


slot_transpose.launches = 0


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


def gather_mean_bwd_csr_plain(
    d_out: torch.Tensor, mask: torch.Tensor, transpose: SlotTranspose, cap: int
) -> torch.Tensor:
    """Plain version of the K3 backward's gather form, summed as the kernel
    sums: ``d_h[r]`` is the f32 sum over row r's list, in increasing flat
    index, of ``d_out[s] / cnt_s``, cast once to d_out's dtype."""
    k = mask.shape[1]
    offsets = transpose.offsets.long()
    entries = transpose.entries[: int(offsets[-1])].long()
    rows = torch.repeat_interleave(torch.arange(cap, device=d_out.device), offsets[1:] - offsets[:-1])
    entries = entries[torch.argsort(rows * (mask.numel() + 1) + entries)]  # each list in order
    cnt = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    scaled = d_out.float() / cnt[:, None]
    d_h = torch.zeros((cap, d_out.shape[1]), dtype=torch.float32, device=d_out.device)
    d_h.index_add_(0, rows, scaled[entries // k])
    return d_h.to(d_out.dtype)


def _launch_gather_mean_bwd(d_out: torch.Tensor, mask: torch.Tensor, ws: torch.Tensor, cap: int) -> torch.Tensor:
    """The K3 backward kernels: d_out checked by the caller, mask (which
    gives the slot table's shape) and the transpose workspace ``ws`` by the
    forward that built it."""
    F = d_out.shape[1]
    d_h = d_out.new_empty((cap, F))
    if cap == 0 or F == 0:
        return d_h
    rc = _lib().dg_gather_mean_bwd(
        d_out.data_ptr(), ws.data_ptr(), d_h.data_ptr(),
        cap, mask.shape[0], mask.shape[1], F, _DTYPE_CODES[d_out.dtype], stream_of(d_out),
    )
    check_launch(rc, "gather_mean_bwd")
    gather_mean_bwd.launches += 1
    return d_h


def _check_d_out(d_out: torch.Tensor, mask: torch.Tensor) -> None:
    """Raise ``ValueError`` unless d_out suits the backward of a forward
    whose mask is ``mask``."""
    require(d_out.is_cuda, "d_out must lie on a CUDA device")
    _check_rows(d_out, "d_out")
    require(d_out.get_device() == mask.get_device(), "d_out must lie on the forward's device")
    if d_out.shape[0] != mask.shape[0]:
        raise ValueError(f"d_out has {d_out.shape[0]} rows, slots {mask.shape[0]}")


def gather_mean_bwd(
    d_out: torch.Tensor,  # [S, F] float32 or bfloat16
    slots: torch.Tensor,  # [S, k] int32
    mask: torch.Tensor,  # [S, k] bool
    cap: int,
) -> torch.Tensor:
    """Gradient of :func:`gather_mean` with respect to h_src, [cap, F] in
    d_out's dtype — on the card the slot table's transpose
    (:func:`slot_transpose`), then the K3 backward kernel (plain version:
    :func:`gather_mean_bwd_plain`).  In a training step the forward builds
    the transpose and the backward launches the kernel alone.

    The kernels sum each row of d_h in f32 in increasing flat slot index
    and round once: the same bits on every run, at any slot-table size; f32
    results agree with the plain version to rounding (the card check holds
    them to 1e-4 of the largest magnitude), bf16 to 5e-2."""
    if d_out.device.type == "cpu":
        return gather_mean_bwd_plain(d_out, slots, mask, cap)
    _check_d_out(d_out, mask)
    _check_slots(slots, mask, d_out.get_device())
    return _launch_gather_mean_bwd(d_out, mask, _build_transpose(slots, mask, cap, _new_ws(slots, cap)), cap)


gather_mean_bwd.launches = 0


class _GatherMean(torch.autograd.Function):
    """K3 forward with the K3 backward as its gradient (slots and mask get
    none).  On the card the forward checks slots and mask once and builds
    the slot transpose for the backward, which then checks only d_out."""

    @staticmethod
    def forward(ctx, h_src, slots, mask):
        ctx.save_for_backward(slots, mask)
        ctx.cap = h_src.shape[0]
        if h_src.device.type == "cpu":
            ctx.ws = None
            return spmm.gather_mean(h_src, slots, mask)
        _check_k3(h_src, slots, mask)
        ctx.ws = _new_ws(slots, ctx.cap)
        return _launch_gather_mean(h_src, slots, mask, ctx.ws)

    @staticmethod
    def backward(ctx, d_out):
        slots, mask = ctx.saved_tensors
        d_out = d_out.contiguous()
        if ctx.ws is None:
            return gather_mean_bwd_plain(d_out, slots, mask, ctx.cap), None, None
        _check_d_out(d_out, mask)
        return _launch_gather_mean_bwd(d_out, mask, ctx.ws, ctx.cap), None, None


def _check_k3(h_src: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor) -> None:
    require(h_src.is_cuda, "h_src must lie on a CUDA device")
    _check_rows(h_src, "h_src")
    _check_slots(slots, mask, h_src.get_device())


def gather_mean(
    h_src: torch.Tensor,  # [cap, F] float32 or bfloat16
    slots: torch.Tensor,  # [S, k] int32 positions into h_src
    mask: torch.Tensor,  # [S, k] bool
) -> torch.Tensor:
    """Masked neighbour mean per destination row, [S, F] in h's dtype — K3
    on the card (plain version: :func:`spmm.gather_mean`),
    differentiable in h_src through :func:`gather_mean_bwd`.  Without a
    gradient to track it launches the kernel directly, with no autograd
    node and no transpose.

    Sums in f32 and rounds once, so bf16 results differ from the plain
    version (which rounds the sum and the quotient in bf16) by rounding:
    the card check holds bf16 to rtol 1e-2 and f32 to rtol 1e-5."""
    if _needs_grad(h_src):
        return _GatherMean.apply(h_src, slots, mask)
    if not h_src.is_cuda and h_src.device.type == "cpu":
        return spmm.gather_mean(h_src, slots, mask)
    _check_k3(h_src, slots, mask)
    return _launch_gather_mean(h_src, slots, mask)


gather_mean.launches = 0


# ---- K3-csr: the full-graph walk ---------------------------------------------------------------

CSR_LIGHT_MAX = 256  # csrc/gather.cu kCsrLightMax: rows with more in-edges are heavy


class CsrPlan(NamedTuple):
    """K3-csr's heavy rows of a CSC: those with more than
    :data:`CSR_LIGHT_MAX` in-edges.  ``rows`` is [N] int32, whose first
    ``n_heavy`` entries are the heavy rows (on the card in no fixed order;
    in the plain version increasing, the rest -1); ``n_heavy`` and
    ``heavy_edges`` (their in-edges) are 0-d int64 tensors on indptr's
    device."""

    rows: torch.Tensor
    n_heavy: torch.Tensor
    heavy_edges: torch.Tensor


def csr_plan_plain(indptr: torch.Tensor) -> CsrPlan:
    """Plain version of :func:`csr_plan`."""
    deg = indptr[1:] - indptr[:-1]
    heavy = torch.nonzero(deg > CSR_LIGHT_MAX).reshape(-1)
    rows = torch.full((deg.numel(),), -1, dtype=torch.int32, device=indptr.device)
    rows[: heavy.numel()] = heavy.to(torch.int32)
    counts = torch.stack([torch.tensor(heavy.numel(), device=indptr.device), deg[heavy].sum().to(torch.int64)])
    return CsrPlan(rows, counts[0], counts[1])


def _check_indptr(indptr: torch.Tensor, index: int) -> None:
    if indptr.get_device() != index:
        raise ValueError(f"indptr must lie on CUDA device {index}")
    require(
        indptr.dtype == torch.int64 and indptr.dim() == 1 and indptr.numel() >= 1 and indptr.is_contiguous(),
        "indptr must be a contiguous non-empty 1-D int64 tensor",
    )


def csr_plan(indptr: torch.Tensor, nnz: int) -> CsrPlan:
    """The heavy rows of the CSC ``indptr`` ([N + 1] int64) over ``nnz``
    edges (the kernels clamp each row's edges into them), which
    :func:`gather_mean_csr` gives one block each — on the card one kernel
    over the rows and a zero fill, no read-back (plain version:
    :func:`csr_plan_plain`).  Build it once for a graph and pass it to
    every layer's walk."""
    if indptr.device.type == "cpu":
        return csr_plan_plain(indptr)
    require(indptr.is_cuda, "indptr must lie on a CUDA device")
    _check_indptr(indptr, indptr.get_device())
    n_rows = indptr.numel() - 1
    counts = torch.zeros(2, dtype=torch.int64, device=indptr.device)
    rows = torch.empty(n_rows, dtype=torch.int32, device=indptr.device)
    rc = _lib().dg_csr_plan(indptr.data_ptr(), n_rows, nnz, rows.data_ptr(), counts.data_ptr(), stream_of(indptr))
    check_launch(rc, "csr_plan")
    csr_plan.launches += 1
    return CsrPlan(rows, counts[0], counts[1])


csr_plan.launches = 0


def _check_csr(h: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, index: int) -> None:
    """Raise ``ValueError`` unless h, indptr and indices suit K3-csr on
    device ``index`` (the checks that keep its kernels inside their
    allocations; they clamp each row's edges into indices and each id into
    h)."""
    _check_rows(h, "h")
    _check_indptr(indptr, index)
    if indices.get_device() != index:
        raise ValueError(f"indices must lie on CUDA device {index}")
    require(
        indices.dtype == torch.int32 and indices.dim() == 1 and indices.is_contiguous(),
        "indices must be a contiguous 1-D int32 tensor",
    )
    if indptr.numel() != h.shape[0] + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries, h {h.shape[0]} rows: it needs N + 1")


def gather_mean_csr_plain(
    h: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, mean: bool = True, edge_chunk: int = 1 << 18
) -> torch.Tensor:
    """Plain version of :func:`gather_mean_csr`: the source rows of each
    ``edge_chunk`` edges gathered, cast to f32 and added into an [N, F] f32
    sum with ``index_add_``, divided by ``max(deg, 1)`` for the mean, then
    cast once to h's dtype."""
    N = indptr.numel() - 1
    nnz = indices.numel()
    deg = indptr[1:] - indptr[:-1]
    erows = torch.repeat_interleave(torch.arange(N, device=h.device), deg, output_size=nnz)
    acc = torch.zeros((N, h.shape[1]), dtype=torch.float32, device=h.device)
    for b0 in range(0, nnz, edge_chunk):
        acc.index_add_(0, erows[b0 : b0 + edge_chunk], gather_rows_plain(h, indices[b0 : b0 + edge_chunk]).float())
    if mean:
        acc = acc / torch.clamp(deg, min=1).to(torch.float32)[:, None]
    return acc.to(h.dtype)


def gather_mean_csr(
    h: torch.Tensor,  # [N, F] float32 or bfloat16
    indptr: torch.Tensor,  # [N + 1] int64: row r's in-edges are indices[indptr[r]:indptr[r+1]]
    indices: torch.Tensor,  # [nnz] int32 source rows
    mean: bool = True,
    plan: Optional[CsrPlan] = None,
    edge_chunk: int = 1 << 18,
) -> torch.Tensor:
    """The sum over each row's CSC in-edges of h[src], divided by
    ``max(deg, 1)`` when ``mean`` (SAGE) or not (GCN), [N, F] in h's dtype,
    rows with no in-edge 0 — K3-csr on the card (plain version:
    :func:`gather_mean_csr_plain`, which walks ``edge_chunk`` edges at a
    time; the kernel ignores it).  ``plan`` is :func:`csr_plan` of
    ``indptr``, built here when not given.

    The kernels sum each row in f32 in CSC order and round once, the mean's
    division before the rounding: the same bits on every call, and the
    plain version's up to the order of the f32 sum."""
    if h.device.type == "cpu":
        return gather_mean_csr_plain(h, indptr, indices, mean, edge_chunk)
    require(h.is_cuda, "h must lie on a CUDA device")
    _check_csr(h, indptr, indices, h.get_device())
    N, F = h.shape
    if plan is None:
        plan = csr_plan(indptr, indices.numel())
    require(
        plan.rows.get_device() == h.get_device() and plan.rows.numel() == N and plan.n_heavy.dtype == torch.int64,
        "plan must be csr_plan of this indptr",
    )
    out = h.new_empty((N, F))
    rc = _lib().dg_gather_mean_csr(
        h.data_ptr(), indptr.data_ptr(), indices.data_ptr(), plan.rows.data_ptr(), plan.n_heavy.data_ptr(),
        out.data_ptr(), N, N, indices.numel(), F, _DTYPE_CODES[h.dtype], int(mean), stream_of(h),
    )
    check_launch(rc, "gather_mean_csr")
    gather_mean_csr.launches += 1
    return out


gather_mean_csr.launches = 0
