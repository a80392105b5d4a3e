"""Dot-product attention over one sampled hop: K9 (the scores) and K9-bwd,
with K4 and K5 (``ops/gat.py``) for the softmax, the weighted sum and the
value projection.

The score of row i's slot k under head h is ``q_ih . k_jh / sqrt(D)`` with
``k_jh = W_k,h x_j``.  Folded through W_k it is ``qt[h, i] . x_n[k, i]``,
``qt[h, i] = W_k,h^T q_ih``: the keys are never projected, and a row's H
folded queries [H, E] meet its K neighbour rows as they lie in K4's
k-major layout.  GAT's score splits into two shared vectors (``ops/gat.py``
folds them into two matmuls); this one differs for every row, so it is a
kernel of its own.  K4 and K5 then take the scores as ``er3`` with ``el = 0``
and a slope of 1, where their LeakyReLU is the identity.

Layouts: x_n [K, S, E] k-major neighbour inputs, qt [H, S, E], mask_f [S, K]
f32, scores [K, S, H] f32, w_v [E, H*D] with head h in columns
[h*D, (h+1)*D) (K4's w).

:func:`score_fwd` and :func:`score_bwd` take their plain versions
(:func:`score_fwd_plain`, :func:`score_bwd_plain`) for CPU tensors and only
for them; a CUDA tensor launches the kernel (``csrc/attention.cu``) or
raises.  Each counts its launches in ``.launches``.  :func:`attn_plan` sizes
every launch and raises ``ValueError`` before a launch that cannot fit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.kernels.launch import check_launch, require, stream_of
from dist_gnn_tpu_torch.ops import gat as gat_ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
ROWS = 8  # csrc/attention.cu: one warp per row, 8 warps a block


class AttnPlan(NamedTuple):
    """One launch of K9 or K9-bwd: ``rows`` rows a block (a warp each) over
    ``grid`` blocks."""

    rows: int
    grid: int


@functools.lru_cache(maxsize=256)
def attn_plan(K: int, S: int, E: int, H: int, dtype: torch.dtype) -> AttnPlan:
    """The launch plan of K9 and K9-bwd for a hop of S rows, K slots, E
    input features and H heads.  Raises ``ValueError`` outside the
    envelope that K4 and K5 share (``gat_ops.fits_kernels``)."""
    require(dtype in _DTYPE_CODES, f"dtype {dtype} is not float32 or bfloat16")
    require(S >= 1 and gat_ops.fits_kernels(K, E, H),
            f"K={K}, S={S}, E={E}, H={H} is outside the attention kernels' envelope")
    return AttnPlan(ROWS, -(-S // ROWS))


def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.dg_attn_score_fwd.argtypes = [p, p, p, p, i32, i64, i32, i32, f32, i32, i32, i32, p]
        lib.dg_attn_score_fwd.restype = i32
        lib.dg_attn_score_bwd.argtypes = [p, p, p, p, p, p, i32, i64, i32, i32, f32, i32, i32, i32, p]
        lib.dg_attn_score_bwd.restype = i32
        lib._argtypes_set = True
    return lib


# ---- plain versions ---------------------------------------------------------


def score_fwd_plain(x_n, qt, mask_f, scale: float) -> torch.Tensor:
    """Plain version of K9: [K, S, H] f32, ``scale * qt[h, i] . x_n[k, i]``
    with f32 sums, less each row's and head's largest valid score; masked
    slots, and rows with no valid slot, 0."""
    s = torch.einsum("kse,hse->ksh", x_n.float(), qt.float()) * scale
    valid = mask_f.T[:, :, None] > 0
    top = torch.amax(torch.where(valid, s, _NEG), dim=0, keepdim=True)
    return torch.where(valid, s - top, 0.0)


def score_bwd_plain(x_n, qt, mask_f, ds, dxn: Optional[torch.Tensor], scale: float):
    """Plain version of K9-bwd: ``(dqt [H, S, E], dxn [K, S, E] or None)``
    in x's dtype, for the scores' gradient ``ds`` [K, S, H] f32; ``dxn``
    (K5's) comes back with the scores' part added at the valid slots."""
    d = torch.where(mask_f.T[:, :, None] > 0, ds.float(), 0.0) * scale
    dqt = torch.einsum("ksh,kse->hse", d, x_n.float()).to(x_n.dtype)
    if dxn is not None:
        dxn = (dxn.float() + torch.einsum("ksh,hse->kse", d, qt.float())).to(dxn.dtype)
    return dqt, dxn


# ---- kernel wrappers --------------------------------------------------------


def _check_layout(x_n, qt, mask_f) -> Tuple[int, int, int, int]:
    """``(K, S, E, H)`` of a launch's inputs, or ``ValueError``."""
    require(x_n.dtype in _DTYPE_CODES, f"x_n dtype {x_n.dtype} is not float32 or bfloat16")
    require(qt.dtype == x_n.dtype, f"qt dtype {qt.dtype} differs from x_n's {x_n.dtype}")
    require(mask_f.dtype == torch.float32, "mask_f must be float32")
    require(x_n.dim() == 3, "x_n must be [K, S, E]")
    K, S, E = x_n.shape
    require(qt.dim() == 3 and qt.shape[1:] == (S, E), "qt must be [H, S, E]")
    require(mask_f.shape == (S, K), "mask_f must be [S, K]")
    for name, t in (("x_n", x_n), ("qt", qt), ("mask_f", mask_f)):
        require(t.is_contiguous(), f"{name} must be contiguous")
    return K, S, E, qt.shape[0]


def _check(x_n, qt, mask_f) -> Tuple[int, int, int, int]:
    require(all(t.is_cuda and t.device == x_n.device for t in (x_n, qt, mask_f)),
            "x_n, qt and mask_f must share one CUDA device")
    return _check_layout(x_n, qt, mask_f)


def score_fwd(x_n, qt, mask_f, scale: float) -> torch.Tensor:
    """K9: the scores [K, S, H] f32 (plain version: :func:`score_fwd_plain`)."""
    if x_n.device.type == "cpu":
        return score_fwd_plain(x_n, qt, mask_f, scale)
    K, S, E, H = _check(x_n, qt, mask_f)
    plan = attn_plan(K, S, E, H, x_n.dtype)
    s = torch.empty((K, S, H), dtype=torch.float32, device=x_n.device)
    rc = _lib().dg_attn_score_fwd(x_n.data_ptr(), qt.data_ptr(), mask_f.data_ptr(), s.data_ptr(), K, S, E, H,
                                  float(scale), _DTYPE_CODES[x_n.dtype], plan.rows, plan.grid, stream_of(x_n))
    check_launch(rc, "attn_score_fwd")
    score_fwd.launches += 1
    return s


score_fwd.launches = 0


def score_bwd(x_n, qt, mask_f, ds, dxn: Optional[torch.Tensor], scale: float):
    """K9-bwd: ``(dqt, dxn)`` for the scores' gradient ``ds``; ``dxn``, when
    given, is added to in place and returned (plain version:
    :func:`score_bwd_plain`)."""
    if x_n.device.type == "cpu":
        return score_bwd_plain(x_n, qt, mask_f, ds, dxn, scale)
    K, S, E, H = _check(x_n, qt, mask_f)
    require(ds.device == x_n.device and ds.dtype == torch.float32 and ds.shape == (K, S, H)
            and ds.is_contiguous(), "ds must be a contiguous [K, S, H] float32 tensor")
    require(dxn is None or (dxn.device == x_n.device and dxn.dtype == x_n.dtype and dxn.shape == x_n.shape
                            and dxn.is_contiguous()), "dxn must be a contiguous tensor like x_n")
    plan = attn_plan(K, S, E, H, x_n.dtype)
    dqt = torch.empty_like(qt)
    rc = _lib().dg_attn_score_bwd(x_n.data_ptr(), qt.data_ptr(), mask_f.data_ptr(), ds.data_ptr(),
                                  dxn.data_ptr() if dxn is not None else None, dqt.data_ptr(), K, S, E, H,
                                  float(scale), _DTYPE_CODES[x_n.dtype], plan.rows, plan.grid, stream_of(x_n))
    check_launch(rc, "attn_score_bwd")
    score_bwd.launches += 1
    return dqt, dxn


score_bwd.launches = 0


class _AttnCore(torch.autograd.Function):
    """K9, then K4 at ``el = 0`` and slope 1; backward K5, then K9-bwd on
    K5's score gradient, adding into K5's d_x.  Returns the gradients of
    x_n (None without ``need_dx``), qt and w_v; the mask takes none."""

    @staticmethod
    def forward(ctx, x_n, qt, mask_f, w_v, scale, need_dx):
        s = score_fwd(x_n, qt, mask_f, scale)
        el = torch.zeros((x_n.shape[1], qt.shape[0]), dtype=torch.float32, device=x_n.device)
        ctx.save_for_backward(x_n, qt, mask_f, w_v, el, s)
        ctx.scale, ctx.need_dx = scale, need_dx
        return gat_ops.gat_fwd(x_n, el, s, mask_f, w_v, 1.0)

    @staticmethod
    def backward(ctx, g):
        x_n, qt, mask_f, w_v, el, s = ctx.saved_tensors
        dw, _, ds, dxn = gat_ops.gat_bwd(x_n, el, s, mask_f, w_v, g.contiguous(), 1.0, ctx.need_dx)
        dqt, dxn = score_bwd(x_n, qt, mask_f, ds, dxn, ctx.scale)
        return dxn, dqt, None, dw.to(w_v.dtype), None, None


def dot_attention(x_dst, x_n, mask_f, w_q, w_k, w_v, b_q, num_heads: int, need_dx: bool) -> torch.Tensor:
    """Multi-head dot-product attention of S rows over their K sampled
    neighbours: ``sum_j alpha_ijh W_v,h x_j`` per head, [S, H*D] in x_n's
    dtype, with ``alpha = softmax_j(q_ih . W_k,h x_j / sqrt(D))`` and
    ``q_ih = W_q,h x_i + b_q,h``.  A row with no valid slot gives 0.

    x_dst [S, E]; x_n [K, S, E] k-major; mask_f [S, K] f32; w_q, w_k, w_v
    [E, H*D] in x's dtype; b_q [H*D] f32.  The query and its fold are two
    matmuls outside the kernels (autograd differentiates them), in x's
    dtype with f32 sums.  ``need_dx=False`` detaches the inputs, so no d_x
    is computed at all (the first layer's features need none)."""
    K, S, E = x_n.shape
    H = num_heads
    D = w_v.shape[1] // H
    if not need_dx:
        x_dst, x_n = x_dst.detach(), x_n.detach()
    q = ((x_dst @ w_q).float() + b_q).to(x_n.dtype).reshape(S, H, D)
    qt = torch.matmul(q.transpose(0, 1), w_k.reshape(E, H, D).permute(1, 2, 0))  # [H, S, E]
    return _AttnCore.apply(x_n.contiguous(), qt.contiguous(), mask_f.contiguous(), w_v.contiguous(),
                           1.0 / math.sqrt(D), need_dx)
