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
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.ops.gather import _check_launch, _require, _stream

# The kernels' own envelope (csrc/gat.cu): at most 32 slots and 8 heads per
# row, and a row's scratch must fit one block's shared memory.
MAX_K = 32
MAX_HEADS = 8
MAX_E = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def _lib() -> ctypes.CDLL:
    lib = build.load("gat")
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.dg_gat_fwd.argtypes = [p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32, p]
        lib.dg_gat_fwd.restype = i32
        lib.dg_gat_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32, p,
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
    _require(
        all(t.is_cuda and t.device == x_n.device for t in (x_n, el, er3, mask_f, w)),
        "x_n, el, er3, mask_f and w must share one CUDA device",
    )
    _require(x_n.dtype in _DTYPE_CODES, f"x_n dtype {x_n.dtype} is not float32 or bfloat16")
    _require(w.dtype == x_n.dtype, f"w dtype {w.dtype} differs from x_n's {x_n.dtype}")
    _require(
        el.dtype == er3.dtype == mask_f.dtype == torch.float32,
        "el, er3 and mask_f must be float32",
    )
    _require(x_n.dim() == 3, "x_n must be [K, S, E]")
    K, S, E = x_n.shape
    _require(el.dim() == 2 and el.shape[0] == S, "el must be [S, H]")
    H = el.shape[1]
    _require(er3.shape == (K, S, H), "er3 must be [K, S, H]")
    _require(mask_f.shape == (S, K), "mask_f must be [S, K]")
    _require(w.dim() == 2 and w.shape[0] == E and H > 0 and w.shape[1] % H == 0, "w must be [E, H*D]")
    _require(fits_kernels(K, E, H), f"K={K}, E={E}, H={H} is outside the GAT kernels' envelope")
    for name, t in (("x_n", x_n), ("el", el), ("er3", er3), ("mask_f", mask_f), ("w", w)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
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
    rc = _lib().dg_gat_fwd(
        x_n.data_ptr(), el.data_ptr(), er3.data_ptr(), mask_f.data_ptr(), w.data_ptr(),
        out.data_ptr(), K, S, E, H, D, float(slope), _DTYPE_CODES[x_n.dtype], _stream(x_n),
    )
    _check_launch(rc, "gat_fwd")
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
    _require(
        g.device == x_n.device and g.dtype == x_n.dtype and g.shape == (S, H * D) and g.is_contiguous(),
        "g must be a contiguous [S, H*D] tensor like the forward's output",
    )
    dev, dt = x_n.device, x_n.dtype
    dw = torch.zeros((E, H * D), dtype=torch.float32, device=dev)
    d_el = torch.zeros((S, H), dtype=torch.float32, device=dev)
    d_er3 = torch.zeros((K, S, H), dtype=torch.float32, device=dev)
    dxn = torch.zeros((K, S, E), dtype=dt, device=dev) if need_dx else None
    if S == 0 or D == 0:
        return dw, d_el, d_er3, dxn
    w_t = w.t().contiguous()  # [H*D, E]: K5 reads W's columns as rows
    aggs = torch.empty((S, H, E), dtype=dt, device=dev)  # per-row agg, for dW
    rc = _lib().dg_gat_bwd(
        x_n.data_ptr(), el.data_ptr(), er3.data_ptr(), mask_f.data_ptr(), w_t.data_ptr(),
        g.data_ptr(), dw.data_ptr(), d_el.data_ptr(), d_er3.data_ptr(),
        dxn.data_ptr() if need_dx else None, aggs.data_ptr(),
        K, S, E, H, D, float(slope), _DTYPE_CODES[dt], _stream(x_n),
    )
    _check_launch(rc, "gat_bwd")
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
