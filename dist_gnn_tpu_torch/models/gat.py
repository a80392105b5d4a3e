"""GAT over static padded blocks (SDDMM + edge softmax + SpMM).

Counterpart of ``dist_gnn_tpu/models/gat.py`` as an ``nn.Module``, in the
aggregate-then-project form: attention commutes with the shared projection
W, so per head the weighted sum runs over the raw inputs and one
[S, d_in] x [d_in, d] product follows; the scores fold through W too
(a_l . (W x) = (W a_l) . x).

Parameters keep the JAX names and layout per ``layer{l}``: ``w`` [d_in,
H*d_out], ``a_l`` and ``a_r`` [H, d_out], ``b`` [H*d_out], f32, so
``weights.gat_params_from_jax`` maps one onto the other by name.

A layer takes the fused path (``ops/gat.py``: K4 forward, K5 backward on
the card) when ``use_fused`` asks for it and :meth:`GAT.fused_ok` passes,
and the plain masked-softmax path otherwise, chosen explicitly.  Two TPU
layout rules of the JAX model are gone: the pad of the last layer to 128
columns and the row-block divisibility in ``fused_ok``; only the CUDA
kernels' own limits remain, which every layer of the bench config meets.
Each layer's input is cast to the compute dtype (the JAX model feeds hidden
layers in the input's dtype; the two agree whenever the input comes in the
compute dtype, as on the bench config).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dist_gnn_tpu_torch.models.sage import _dropout, _glorot, _key_source
from dist_gnn_tpu_torch.ops import gat as gat_ops
from dist_gnn_tpu_torch.ops.spmm import masked_segment_softmax
from dist_gnn_tpu_torch.sampler import Block
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


class GAT(nn.Module):
    def __init__(
        self,
        in_feats: int,
        n_hidden: int,
        n_classes: int,
        num_layers: int,
        num_heads: int = 4,
        dropout: float = 0.5,
        negative_slope: float = 0.2,
        compute_dtype: Optional[torch.dtype] = None,
        use_fused=True,
        input_grad: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """Glorot-uniform ``w``, ``0.1 * randn`` attention vectors and zero
        biases, f32, drawn on the CPU from ``generator`` (a fresh unseeded
        one if None), then placed on ``device`` (default: the card).

        ``use_fused``: True, False, or a collection of layer indices that
        take the fused kernels.  ``input_grad``: callers differentiate with
        respect to the first layer's input (training never does; the fused
        path then skips d_x on that layer)."""
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.num_heads = num_heads
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.use_fused = (
            use_fused if isinstance(use_fused, bool) else frozenset(int(i) for i in use_fused)
        )
        self.input_grad = input_grad
        self.dims: List[tuple] = []
        H = num_heads
        for l in range(num_layers):
            d_in = in_feats if l == 0 else n_hidden * H
            last = l == num_layers - 1
            d_out = n_classes if last else n_hidden
            self.dims.append((d_in, d_out, last))
            layer = nn.ParameterDict(
                {
                    "w": nn.Parameter(_glorot((d_in, H * d_out), gen)),
                    "a_l": nn.Parameter(torch.randn((H, d_out), generator=gen) * 0.1),
                    "a_r": nn.Parameter(torch.randn((H, d_out), generator=gen) * 0.1),
                    "b": nn.Parameter(torch.zeros(H * d_out)),
                }
            )
            self.add_module(f"layer{l}", layer.to(dev))

    def layer_params(self, l: int) -> nn.ParameterDict:
        return getattr(self, f"layer{l}")

    @staticmethod
    def fused_ok(S: int, k: int, d_in: int, num_heads: int = 4) -> bool:
        """Whether a hop of shape (S dst rows, k slots, d_in features) takes
        the fused kernels: only their own envelope (k <= 32, d_in <= 1024,
        at most 8 heads) counts; any S and any head width D do."""
        return S >= 1 and gat_ops.fits_kernels(k, d_in, num_heads)

    def _wants_fused(self, l: int) -> bool:
        return self.use_fused if isinstance(self.use_fused, bool) else l in self.use_fused

    def _fused_layer(self, p, h, block: Block, l: int, contiguous_first: bool) -> torch.Tensor:
        """K4/K5 path (gat.py:175-212): [S, H*d_out] in h's dtype."""
        d_in, d_out, _ = self.dims[l]
        H = self.num_heads
        S_, k_ = block.neigh_mask.shape
        w32 = p["w"].float().reshape(d_in, H, d_out)
        wal = torch.einsum("ehd,hd->eh", w32, p["a_l"].float())
        war = torch.einsum("ehd,hd->eh", w32, p["a_r"].float())
        x_dst = h[:S_]
        if l == 0 and contiguous_first:
            # k-major dedup-free hop: a free reshape to [k, S, E]
            x_n = h[S_:].reshape(k_, S_, d_in)
        else:
            safe = torch.where(block.neigh_mask, block.neigh_slots, 0)
            x_n = h[safe.T.long()]  # [k, S, E] k-major gather
        return gat_ops.gat_attention(
            x_dst, x_n, block.neigh_mask.float(), wal.to(h.dtype), war.to(h.dtype),
            p["w"].to(h.dtype), self.negative_slope, l > 0 or self.input_grad,
        )

    def _plain_layer(self, p, h, block: Block, l: int, contiguous_first: bool) -> List[torch.Tensor]:
        """Masked-softmax path (gat.py:227-272): per-head [S, d_out]."""
        d_in, d_out, _ = self.dims[l]
        H = self.num_heads
        S_, k_ = block.neigh_mask.shape
        w = p["w"].to(h.dtype)
        eye = torch.eye(H, dtype=torch.float32, device=h.device)
        al = torch.einsum("hd,hg->hdg", p["a_l"].float(), eye).reshape(H * d_out, H)
        ar = torch.einsum("hd,hg->hdg", p["a_r"].float(), eye).reshape(H * d_out, H)
        wa = w.float() @ torch.cat([al, ar], dim=1)  # [d_in, 2H]
        eler = (h.float() @ wa.to(h.dtype).float())  # [*, 2H], f32 sums
        el = eler[:S_, :H]
        if l == 0 and contiguous_first:
            er_n = eler[S_:, H:].reshape(k_, S_, H).transpose(0, 1)
            x_n = h[S_:].reshape(k_, S_, d_in).transpose(0, 1)
        else:
            slots = block.neigh_slots.long()
            er_n = eler[slots][..., H:]
            x_n = h[slots]  # [S, k, d_in]
        scores = F.leaky_relu(el[:, None, :] + er_n, self.negative_slope)
        alpha = masked_segment_softmax(scores, block.neigh_mask)  # [S, k, H]
        outs = []
        for hh in range(H):
            agg = torch.sum(x_n * alpha[:, :, hh, None].to(x_n.dtype), dim=1)
            outs.append((agg @ w[:, hh * d_out : (hh + 1) * d_out]).to(x_n.dtype))
        return outs

    def forward(
        self,
        blocks: Sequence[Block],
        x: torch.Tensor,  # [cap_deepest_frontier, in_feats]
        *,
        train: bool = False,
        rng=None,
        contiguous_first: bool = False,
    ) -> torch.Tensor:
        """``blocks`` input-first (``reversed`` sampler output); ``x`` the
        features of ``blocks[0]``'s frontier.  Returns logits [B, n_classes]
        in x's dtype.

        ``train`` turns dropout on between layers; its row keys come from
        ``rng``: a ``torch.Generator``, or a sequence of [S_l] key tensors,
        one per dropout layer in order (how tests inject the JAX keys).
        ``contiguous_first``: the first block came from a dedup-free hop."""
        if len(blocks) != len(self.dims):
            raise ValueError(f"{len(blocks)} blocks for a {len(self.dims)}-layer model")
        H = self.num_heads
        cd = self.compute_dtype if self.compute_dtype is not None else x.dtype
        keys = _key_source(rng) if train and self.dropout > 0 else None
        h = x
        for l, block in enumerate(blocks):
            d_in, d_out, last = self.dims[l]
            p = self.layer_params(l)
            h = h.to(cd)
            S_, k_ = block.neigh_mask.shape
            if self._wants_fused(l) and self.fused_ok(S_, k_, d_in, H):
                out = self._fused_layer(p, h, block, l, contiguous_first)
                if last:
                    h = out.reshape(S_, H, d_out).mean(dim=1) + p["b"].reshape(H, d_out).mean(0)
                else:
                    h = F.elu(out + p["b"])
            else:
                outs = self._plain_layer(p, h, block, l, contiguous_first)
                if last:
                    h = sum(outs[1:], outs[0]) / H + p["b"].reshape(H, d_out).mean(0)
                else:
                    h = F.elu(torch.cat(outs, dim=1) + p["b"])
            if not last and keys is not None:
                h = _dropout(h, keys(h.shape[0], h.device), self.dropout)
            h = h.to(x.dtype)
        return h
