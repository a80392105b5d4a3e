"""Fused GAT attention over one sampled hop: K4 (forward) and K5 (backward).

Counterpart of ``dist_gnn_tpu/ops/gat_pallas.py``, with its layouts: x_n
[K, S, E] k-major neighbour inputs (slot k of every row contiguous, the
native layout of the dedup-free first hop), mask_f [S, K] f32, w [E, H*D]
with head h in columns [h*D, (h+1)*D).

As in the JAX package, the score halves el = x_dst @ wal and er3 = x_n @
war are two matmuls outside the kernels (gat_pallas.py:336-341), summed in
f32; autograd differentiates them.  :class:`_GATCore` wraps the rest: K4
(softmax, aggregate, project; ``csrc/gat.cu`` ``dg_gat_fwd``) forward and K5
(``dg_gat_bwd``) backward, returning d_x_n, d_el, d_er3 and dW, and no mask
gradient.  The source notes which Pallas kernel each replaces, what bounds
it on the card and what its design does about that.

:func:`gat_fwd` and :func:`gat_bwd` take their plain versions
(:func:`gat_fwd_plain`, :func:`gat_bwd_plain`) for CPU tensors and only for
them; a CUDA tensor launches the kernel or raises.  Each counts its
launches in ``.launches``.  :func:`gat_plan` sizes every launch (rows and
heads per block, padded widths, shared memory, grid) and raises
``ValueError`` before a launch that cannot fit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.kernels.launch import check_launch, require, stream_of

# The kernels' own envelope (csrc/gat.cu): at most 32 slots and 8 heads per
# row, E at most 1024, and a block's tiles must fit its shared memory.
MAX_K = 32
MAX_HEADS = 8
MAX_E = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30

# The card (NVIDIA H100 SXM) and the launch layout of csrc/gat.cu, which
# the launchers check every plan against.
NUM_SMS = 132
SMEM_BLOCK_MAX = 232_448  # bytes one block may opt in to
_SMEM_SM = 233_472  # shared memory of one SM
_SMEM_RESERVED = 1_024  # what the runtime keeps per resident block
_WARPS = 8  # 256 threads a block
_STAGES = 4  # bf16: cp.async stages of W in flight (K5's rows kernel: one fewer)
_FWD_SLICE = 16  # K4 bf16: rows of W per stage where heads start 16-byte aligned
_MAX_TILES_PER_WARP = 16  # K4 bf16: m16n8 f32 accumulators a warp holds
_ROWS_BF16 = (64, 32, 16)
_MAX_ROWS_F32 = 16
_F32_BUDGET = 96 * 1024  # f32 kernels: two blocks per SM where a tile fits
_DW_TILE_E, _DW_TILE_D, _DW_TILE_S = 64, 64, 32
# A block's fixed cost in the plan's score (its serial score chain,
# pipeline fill and barriers), as bytes moved: with it the score ranks
# K4's row and head splits at the GAT bench layers in the order their
# times took on an H100.
_BLOCK_COST = 150_000


class GatPlan(NamedTuple):
    """One launch of K4 (``kernel="fwd"``) or K5 (``"bwd"``): ``rows``
    destination rows and ``heads_per_block`` heads per block, E and D
    padded to ``e_pad``/``d_pad`` in shared memory (bf16), K4 staging
    ``w_rows`` rows of W at a time (bf16), ``smem_bytes`` of dynamic shared
    memory, ``grid`` (row tiles, head groups), how many blocks fit on one
    SM and the grid's share of one wave.  K5 (bf16) keeps ``dal_slots``
    copies of d_alpha, one per column group of warps where they fit (else
    one, shared through atomics), and its dW kernel splits S into
    ``dw_splits`` chunks of ``dw_s_chunk`` rows."""

    kernel: str
    rows: int
    heads_per_block: int
    e_pad: int
    d_pad: int
    w_rows: int
    dal_slots: int
    smem_bytes: int
    grid: Tuple[int, int]
    blocks_per_sm: int
    waves: float
    dw_splits: int
    dw_s_chunk: int


def _a16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _scores_bytes(R, K, H) -> int:
    # the score chain's staged inputs: el [R][H], er3 [K][R][H], mask [R][K], f32
    return R * (H * (K + 1) + K) * 4


def _fwd_bf16_smem(R, K, H, hc, e_pad, d_pad, ks) -> int:
    # alpha f32 [R][K][H]; agg bf16 [hc][R][e_pad + 8] (the staged scores
    # before it); ring [min(stages, slices)][ks][hc d_pad + 8]
    agg = max(hc * R * (e_pad + 8) * 2, _scores_bytes(R, K, H))
    stages = min(_STAGES, -(-e_pad // ks))
    return _a16(R * K * H * 4) + _a16(agg) + stages * ks * (hc * d_pad + 8) * 2


def _bwd_bf16_smem(R, K, H, d_pad, slots) -> int:
    # alpha, pre f32 [R][K][H]; dal f32 [slots][R][K][H] (the staged scores
    # before it); g bf16 [H][R][d_pad + 8]; ring [stages - 1][EC][16 H + 8]
    chunk = 16 * _WARPS // (R // 16)
    dal = max(slots * R * K * H * 4, _scores_bytes(R, K, H))
    return (2 * _a16(R * K * H * 4) + _a16(dal) + _a16(H * R * (d_pad + 8) * 2)
            + (_STAGES - 1) * chunk * (16 * H + 8) * 2)


def _dw_split(S: int, E: int, H: int, D: int, num_sms: int) -> Tuple[int, int]:
    """K5's dW kernel: split S so its grid fills the card once at the four
    blocks an SM holds."""
    tiles = -(-E // _DW_TILE_E) * H * -(-D // _DW_TILE_D)
    s_steps = -(-S // _DW_TILE_S)
    splits = min(-(-4 * num_sms // tiles), s_steps)
    s_chunk = -(-s_steps // splits) * _DW_TILE_S
    return -(-S // s_chunk), s_chunk


@functools.lru_cache(maxsize=256)
def gat_plan(kernel: str, K: int, S: int, E: int, H: int, D: int, dtype: torch.dtype,
             num_sms: int = NUM_SMS) -> GatPlan:
    """The launch plan of K4 (``"fwd"``) or K5 (``"bwd"``) for a hop of S
    rows, K slots, E input features and H heads of width D.

    bf16 runs on the tensor cores: E and D are padded to multiples of 16 in
    shared memory, and each candidate (rows 64/32/16; for K4 also heads per
    block H, H/2, ... 1, splitting the output columns across blocks) is
    scored by the busiest SM's bytes (its x_n tile, half-weighted W from L2,
    its outputs, and a fixed cost per block) over its occupancy (resident
    blocks, two at most); the least score wins, the larger tile on a tie.
    Where rows alone cannot fill ``num_sms`` SMs, that picks a head split.
    f32 keeps the exact-FMA kernels: up to 16 rows whose scratch fits 96
    KB, all heads.  Raises ``ValueError`` outside the envelope or when no
    tile fits."""
    require(kernel in ("fwd", "bwd"), f"kernel must be 'fwd' or 'bwd', not {kernel!r}")
    require(dtype in _DTYPE_CODES, f"dtype {dtype} is not float32 or bfloat16")
    require(S >= 1 and D >= 1 and fits_kernels(K, E, H),
             f"K={K}, S={S}, E={E}, H={H}, D={D} is outside the GAT kernels' envelope")
    splits, s_chunk = _dw_split(S, E, H, D, num_sms) if kernel == "bwd" else (0, 0)

    def made(R, hc, e_pad, d_pad, smem, bps, ks=0, slots=0):
        grid = (-(-S // R), -(-H // hc))
        waves = grid[0] * grid[1] / (num_sms * bps)
        return GatPlan(kernel, R, hc, e_pad, d_pad, ks, slots, smem, grid, bps, waves, splits, s_chunk)

    def fit(smem, cap):
        return min(cap, _SMEM_SM // (smem + _SMEM_RESERVED))

    if dtype == torch.float32:
        row = (K * H + H * E) if kernel == "fwd" else (3 * K * H + H * D + H * E)
        R = min(_MAX_ROWS_F32, _F32_BUDGET // (row * 4)) or (1 if row * 4 <= SMEM_BLOCK_MAX else 0)
        require(R > 0, f"one row's f32 scratch ({row * 4} B) exceeds {SMEM_BLOCK_MAX} B")
        return made(R, H, E, D, R * row * 4, fit(R * row * 4, _WARPS))

    e_pad, d_pad = -(-E // 16) * 16, -(-D // 16) * 16
    # Heads that start off a 16-byte boundary (D not a multiple of 8) are
    # staged by plain copies, which wait for their loads: then K4 takes W in
    # as few slices as fit, all in flight at once, where 16-row slices fit.
    ks_all = -(-e_pad // (_STAGES - 1) // 16) * 16
    ks_options = (_FWD_SLICE,) if D % 8 == 0 else (ks_all, _FWD_SLICE)
    best = None
    hcs = sorted({-(-H // n) for n in (1, 2, 4, 8)}, reverse=True) if kernel == "fwd" else [H]
    for hc in hcs:
        for R in _ROWS_BF16:
            ks = slots = 0
            if kernel == "fwd":
                ks = next((k for k in ks_options
                           if _fwd_bf16_smem(R, K, H, hc, e_pad, d_pad, k) <= SMEM_BLOCK_MAX), _FWD_SLICE)
                smem = _fwd_bf16_smem(R, K, H, hc, e_pad, d_pad, ks)
                wpm = _WARPS // (R // 16)
                if -(-(hc * d_pad // 8) // wpm) > _MAX_TILES_PER_WARP:
                    continue
                work = R * K * E * 2 + E * hc * D + R * hc * D * 2
                cap = 2
            else:
                slots = _WARPS // (R // 16)  # one copy of d_alpha per column group of warps
                if _bwd_bf16_smem(R, K, H, d_pad, slots) > SMEM_BLOCK_MAX:
                    slots = 1
                smem = _bwd_bf16_smem(R, K, H, d_pad, slots)
                work = R * K * E * 2 + E * H * D + R * H * D * 2 + R * H * E * 2
                cap = 2 if H <= 4 else 1
            if smem > SMEM_BLOCK_MAX:
                continue
            bps = fit(smem, cap)
            per_sm = -(-(-(-S // R) * -(-H // hc)) // num_sms)
            score = per_sm * (work + _BLOCK_COST) / (min(bps, per_sm) / 2)
            if best is None or score < best[0]:
                best = (score, made(R, hc, e_pad, d_pad, smem, bps, ks, slots))
    require(best is not None, f"no {kernel} tile fits shared memory at E={E}, H={H}, D={D}, K={K}")
    return best[1]


_NUM_SMS_OF = {}


def _num_sms(device: torch.device) -> int:
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _NUM_SMS_OF:
        _NUM_SMS_OF[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _NUM_SMS_OF[index]


def _lib() -> ctypes.CDLL:
    lib = build.load("gat")
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.dg_gat_fwd.argtypes = [
            p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32, i32, i32, i32, i32, i32, i32, i32, i32, p,
        ]
        lib.dg_gat_fwd.restype = i32
        lib.dg_gat_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32,
            i32, i32, i32, i32, i32, i32, i64, p,
        ]
        lib.dg_gat_bwd.restype = i32
        lib._argtypes_set = True
    return lib


def fits_kernels(K: int, E: int, H: int) -> bool:
    """Whether K4 and K5 take a hop of K slots, E input features and H
    heads."""
    return 1 <= K <= MAX_K and 1 <= E <= MAX_E and 1 <= H <= MAX_HEADS


# ---- plain versions ---------------------------------------------------------


def _alpha(el, er3, mask_f, slope):
    """The score chain of ``_score_chain`` (gat_pallas.py:70): (pre, alpha),
    [K, S, H] f32, with one max over all of a row's K*H scores; masked
    slots, and rows with no valid slot, get alpha exactly 0."""
    pre = el[None] + er3
    s = torch.where(pre >= 0, pre, pre * slope)
    mk = mask_f.T[:, :, None]  # [K, S, 1]
    s = torch.where(mk > 0, s, _NEG)
    g = torch.amax(s, dim=(0, 2), keepdim=True)  # [1, S, 1]
    e = torch.exp(s - g) * mk
    rden = 1.0 / torch.clamp(torch.sum(e, dim=0), min=1e-12)
    return pre, e * rden[None]


def gat_fwd_plain(x_n, el, er3, mask_f, w, slope: float) -> torch.Tensor:
    """Plain version of K4 (the math of ``gat_attention_reference``,
    gat_pallas.py:344, on el and er3): [S, H*D] in x_n's dtype.  alpha is
    rounded to x's dtype before the weighted sum and agg to w's before the
    projection, both summed in f32, as the kernel does."""
    K, S, E = x_n.shape
    H = el.shape[1]
    D = w.shape[1] // H
    _, alpha = _alpha(el, er3, mask_f, slope)
    a_x = alpha.to(x_n.dtype).float()
    agg = torch.einsum("ksh,kse->she", a_x, x_n.float())  # [S, H, E]
    agg = agg.to(w.dtype).float()
    w3 = w.float().reshape(E, H, D)
    out = torch.einsum("she,ehd->shd", agg, w3)
    return out.reshape(S, H * D).to(x_n.dtype)


def gat_bwd_plain(
    x_n, el, er3, mask_f, w, g, slope: float, need_dx: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K5: exactly what ``_bwd_kernel`` (gat_pallas.py:127)
    outputs, ``(dw [E, H*D] f32, d_el [S, H] f32, d_er3 [K, S, H] f32,
    dxn [K, S, E] in x's dtype or None without need_dx)``."""
    K, S, E = x_n.shape
    H = el.shape[1]
    D = w.shape[1] // H
    pre, alpha = _alpha(el, er3, mask_f, slope)
    x = x_n.float()
    g3 = g.float().reshape(S, H, D)
    w3 = w.float().reshape(E, H, D)
    dagg = torch.einsum("shd,ehd->she", g3, w3)  # [S, H, E]
    dal = torch.einsum("kse,she->ksh", x, dagg)
    t = torch.sum(alpha * dal, dim=0)  # [S, H]
    d_pre = alpha * (dal - t[None]) * torch.where(pre >= 0, 1.0, slope)
    agg = torch.einsum("ksh,kse->she", alpha, x).to(w.dtype).float()
    dw = torch.einsum("she,shd->ehd", agg, g3).reshape(E, H * D)
    dxn = torch.einsum("ksh,she->kse", alpha, dagg).to(x_n.dtype) if need_dx else None
    return dw, torch.sum(d_pre, dim=0), d_pre, dxn


# ---- kernel wrappers --------------------------------------------------------


def _check_common(x_n, el, er3, mask_f, w) -> Tuple[int, int, int, int, int]:
    require(
        all(t.is_cuda and t.device == x_n.device for t in (x_n, el, er3, mask_f, w)),
        "x_n, el, er3, mask_f and w must share one CUDA device",
    )
    require(x_n.dtype in _DTYPE_CODES, f"x_n dtype {x_n.dtype} is not float32 or bfloat16")
    require(w.dtype == x_n.dtype, f"w dtype {w.dtype} differs from x_n's {x_n.dtype}")
    require(
        el.dtype == er3.dtype == mask_f.dtype == torch.float32,
        "el, er3 and mask_f must be float32",
    )
    require(x_n.dim() == 3, "x_n must be [K, S, E]")
    K, S, E = x_n.shape
    require(el.dim() == 2 and el.shape[0] == S, "el must be [S, H]")
    H = el.shape[1]
    require(er3.shape == (K, S, H), "er3 must be [K, S, H]")
    require(mask_f.shape == (S, K), "mask_f must be [S, K]")
    require(w.dim() == 2 and w.shape[0] == E and H > 0 and w.shape[1] % H == 0, "w must be [E, H*D]")
    require(fits_kernels(K, E, H), f"K={K}, E={E}, H={H} is outside the GAT kernels' envelope")
    for name, t in (("x_n", x_n), ("el", el), ("er3", er3), ("mask_f", mask_f), ("w", w)):
        require(t.is_contiguous(), f"{name} must be contiguous")
    return K, S, E, H, w.shape[1] // H


def gat_fwd(x_n, el, er3, mask_f, w, slope: float) -> torch.Tensor:
    """K4: masked edge softmax, aggregate and project, [S, H*D] in x's
    dtype (plain version: :func:`gat_fwd_plain`)."""
    if x_n.device.type == "cpu":
        return gat_fwd_plain(x_n, el, er3, mask_f, w, slope)
    K, S, E, H, D = _check_common(x_n, el, er3, mask_f, w)
    out = torch.empty((S, H * D), dtype=x_n.dtype, device=x_n.device)
    if S == 0 or D == 0:
        return out
    plan = gat_plan("fwd", K, S, E, H, D, x_n.dtype, _num_sms(x_n.device))
    rc = _lib().dg_gat_fwd(
        x_n.data_ptr(), el.data_ptr(), er3.data_ptr(), mask_f.data_ptr(), w.data_ptr(),
        out.data_ptr(), K, S, E, H, D, float(slope), _DTYPE_CODES[x_n.dtype],
        plan.rows, plan.heads_per_block, plan.e_pad, plan.d_pad, plan.w_rows, plan.smem_bytes, *plan.grid,
        stream_of(x_n),
    )
    check_launch(rc, "gat_fwd")
    gat_fwd.launches += 1
    return out


gat_fwd.launches = 0


def gat_bwd(x_n, el, er3, mask_f, w, g, slope: float, need_dx: bool):
    """K5: ``(dw f32, d_el f32, d_er3 f32, dxn or None)``, the gradients of
    :func:`gat_fwd` for an output gradient g (plain version:
    :func:`gat_bwd_plain`).  Without ``need_dx`` no d_x is computed.

    dW is summed across blocks with f32 atomics in no fixed order, so it
    agrees with the plain version to rounding, not bit for bit."""
    if x_n.device.type == "cpu":
        return gat_bwd_plain(x_n, el, er3, mask_f, w, g, slope, need_dx)
    K, S, E, H, D = _check_common(x_n, el, er3, mask_f, w)
    require(
        g.device == x_n.device and g.dtype == x_n.dtype and g.shape == (S, H * D) and g.is_contiguous(),
        "g must be a contiguous [S, H*D] tensor like the forward's output",
    )
    dev, dt = x_n.device, x_n.dtype
    # dW takes the blocks' atomic adds; the kernel writes the rest whole
    dw = torch.zeros((E, H * D), dtype=torch.float32, device=dev)
    if S == 0 or D == 0:
        dxn = torch.zeros((K, S, E), dtype=dt, device=dev) if need_dx else None
        return dw, torch.zeros((S, H), device=dev), torch.zeros((K, S, H), device=dev), dxn
    plan = gat_plan("bwd", K, S, E, H, D, dt, _num_sms(dev))
    d_el = torch.empty((S, H), dtype=torch.float32, device=dev)
    d_er3 = torch.empty((K, S, H), dtype=torch.float32, device=dev)
    dxn = torch.empty((K, S, E), dtype=dt, device=dev) if need_dx else None
    aggs = torch.empty((S, H, E), dtype=dt, device=dev)  # per-row agg, for dW
    rc = _lib().dg_gat_bwd(
        x_n.data_ptr(), el.data_ptr(), er3.data_ptr(), mask_f.data_ptr(), w.data_ptr(),
        g.data_ptr(), dw.data_ptr(), d_el.data_ptr(), d_er3.data_ptr(),
        dxn.data_ptr() if need_dx else None, aggs.data_ptr(),
        K, S, E, H, D, float(slope), _DTYPE_CODES[dt],
        plan.rows, plan.d_pad, plan.dal_slots, plan.smem_bytes, plan.grid[0], plan.dw_splits, plan.dw_s_chunk,
        stream_of(x_n),
    )
    check_launch(rc, "gat_bwd")
    gat_bwd.launches += 1
    return dw, d_el, d_er3, dxn


gat_bwd.launches = 0


class _GATCore(torch.autograd.Function):
    """Softmax, aggregate and project over precomputed score halves —
    ``_gat_core`` with ``_core_fwd``/``_core_bwd`` (gat_pallas.py:277-308).
    The backward returns (d_x_n along the alpha path, d_el, d_er3, no mask
    gradient, dW in w's dtype); the el/er3 producers outside differentiate
    normally."""

    @staticmethod
    def forward(ctx, x_n, el, er3, mask_f, w, slope, need_dx):
        ctx.save_for_backward(x_n, el, er3, mask_f, w)
        ctx.slope, ctx.need_dx = slope, need_dx
        return gat_fwd(x_n, el, er3, mask_f, w, slope)

    @staticmethod
    def backward(ctx, g):
        x_n, el, er3, mask_f, w = ctx.saved_tensors
        dw, d_el, d_er3, dxn = gat_bwd(
            x_n, el, er3, mask_f, w, g.contiguous(), ctx.slope, ctx.need_dx
        )
        return dxn, d_el.to(el.dtype), d_er3.to(er3.dtype), None, dw.to(w.dtype), None, None


def gat_attention(x_dst, x_n, mask_f, wal, war, w, slope: float, need_dx: bool) -> torch.Tensor:
    """Fused GAT attention layer over one sampled hop (gat_pallas.py:311).

    x_dst [S, E] destination inputs; x_n [K, S, E] k-major neighbour
    inputs; mask_f [S, K] f32; wal/war [E, H] the folded attention vectors
    W @ A_l and W @ A_r; w [E, H*D].  ``need_dx=False`` detaches the
    inputs, so no d_x is computed at all (the first layer's features need
    none).  Returns [S, H*D] in x_n's dtype."""
    K, S, E = x_n.shape
    H = wal.shape[1]
    if not need_dx:
        x_dst, x_n = x_dst.detach(), x_n.detach()
    # score halves as two matmuls of the exact f32 upcasts (f32 sums)
    el = x_dst.float() @ wal.float()
    er3 = (x_n.reshape(K * S, E).float() @ war.float()).reshape(K, S, H)
    return _GATCore.apply(x_n.contiguous(), el, er3, mask_f.contiguous(), w.contiguous(), slope, need_dx)
