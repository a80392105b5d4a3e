"""Graph transformer over static padded blocks: UniMP's attention layer
with a gated residual (Shi et al., arXiv:2009.03509; PyG's
``TransformerConv(beta=True)``).

Per layer, with H heads of width D over row i's valid sampled neighbours j:

    q_ih = W_q,h x_i + b_q,h     k_jh = W_k,h x_j     v_jh = W_v,h x_j + b_v,h
    alpha_ijh = softmax_j(q_ih . k_jh / sqrt(D))
    m_i = concat_h sum_j alpha_ijh v_jh   (the last layer: the heads' mean;
                                           a row with no valid slot: 0)
    r_i = W_s x_i + b_s
    beta_i = sigmoid(w_g . [m_i ; r_i ; m_i - r_i])
    o_i = beta_i r_i + (1 - beta_i) m_i

and hidden layers take ``dropout(ReLU(LayerNorm(o_i)))``; the last layer's
``o_i`` are the logits.  The key bias is left out: it adds ``q_ih . b_k,h``
to every score of a row, which the softmax cancels.

Parameters per ``layer{l}``, f32: ``w`` [d_in, 3*H*D] (the q, k and v
blocks, heads inside each block as in GAT's ``w``), ``w_self`` [d_in,
width] (width H*D on hidden layers, D on the last), ``b`` [2*H*D + width]
(``b_q``, ``b_v``, ``b_s``), ``g`` [3*width] (the gate), and on hidden
layers ``ln_s`` and ``ln_b`` [width], the LayerNorm's scale stored as an
offset from 1 and its bias.

Every layer's attention is ``ops/attention.dot_attention``: K9, K4 and K5
on the card, where a hop outside their envelope raises ``ValueError``, and
their plain versions on the CPU.  Each layer's input is cast to the compute
dtype; the gate, the mix and the LayerNorm run in f32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dist_gnn_tpu_torch.models.sage import _dropout, _glorot, _key_source
from dist_gnn_tpu_torch.ops import attention as attn_ops
from dist_gnn_tpu_torch.sampler import Block
from dist_gnn_tpu_torch.utils import trace
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device

LN_EPS = 1e-5


class GraphTransformer(nn.Module):
    def __init__(
        self,
        in_feats: int,
        n_hidden: int,
        n_classes: int,
        num_layers: int,
        num_heads: int = 4,
        dropout: float = 0.5,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """Glorot-uniform ``w`` and ``w_self``, zero biases, gate and
        LayerNorm offsets, f32, drawn on the CPU from ``generator`` (a fresh
        unseeded one if None), then placed on ``device`` (default: the
        card).  ``n_hidden`` is the head width D of the hidden layers."""
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.num_heads = num_heads
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.dims: List[tuple] = []
        H = num_heads
        for l in range(num_layers):
            d_in = in_feats if l == 0 else n_hidden * H
            last = l == num_layers - 1
            d_out = n_classes if last else n_hidden
            width = d_out if last else H * d_out
            self.dims.append((d_in, d_out, last))
            params = {
                "w": nn.Parameter(_glorot((d_in, 3 * H * d_out), gen)),
                "w_self": nn.Parameter(_glorot((d_in, width), gen)),
                "b": nn.Parameter(torch.zeros(2 * H * d_out + width)),
                "g": nn.Parameter(torch.zeros(3 * width)),
            }
            if not last:
                params["ln_s"] = nn.Parameter(torch.zeros(width))
                params["ln_b"] = nn.Parameter(torch.zeros(width))
            self.add_module(f"layer{l}", nn.ParameterDict(params).to(dev))

    def layer_params(self, l: int) -> nn.ParameterDict:
        return getattr(self, f"layer{l}")

    def _neighbours(self, h, block: Block, l: int, contiguous_first: bool) -> torch.Tensor:
        """The slots' input rows, k-major: [k, S, d_in].  The dedup-free first
        hop is a free reshape."""
        S_, k_ = block.neigh_mask.shape
        if l == 0 and contiguous_first:
            return h[S_:].reshape(k_, S_, h.shape[1])
        safe = torch.where(block.neigh_mask, block.neigh_slots, 0)
        return h[safe.T.long()]

    def _attend(self, p, x_dst, x_n, block: Block, l: int) -> torch.Tensor:
        """``sum_j alpha_ij W_v x_j`` [S, H*D] in x's dtype."""
        H = self.num_heads
        HD = H * self.dims[l][1]
        w = p["w"].to(x_dst.dtype)
        return attn_ops.dot_attention(
            x_dst, x_n, block.neigh_mask.float(), w[:, :HD], w[:, HD : 2 * HD], w[:, 2 * HD :], p["b"][:HD], H,
            l > 0,  # the first layer's input is the features: no gradient
        )

    def _gate(self, p, x_dst: torch.Tensor, m: torch.Tensor, d_out: int, last: bool) -> torch.Tensor:
        """Root term, gate, mix; on hidden layers LayerNorm and ReLU: f32."""
        width = m.shape[1]
        w_self = p["w_self"].to(x_dst.dtype)
        b_s = p["b"][2 * self.num_heads * d_out :]
        r = (x_dst @ w_self).float() + b_s
        g_m, g_r, g_d = p["g"].split(width)
        beta = torch.sigmoid(m @ (g_m + g_d) + r @ (g_r - g_d))[:, None]
        o = m + beta * (r - m)
        if last:
            return o
        return torch.relu(F.layer_norm(o, (width,), 1.0 + p["ln_s"], p["ln_b"], LN_EPS))

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

        ``train`` turns dropout on after every hidden layer; its row keys
        come from ``rng``: a ``torch.Generator``, or a sequence of [S_l] key
        tensors, one per dropout layer in order.  ``contiguous_first``: the
        first block came from a dedup-free hop."""
        if len(blocks) != len(self.dims):
            raise ValueError(f"{len(blocks)} blocks for a {len(self.dims)}-layer model")
        H = self.num_heads
        cd = self.compute_dtype if self.compute_dtype is not None else x.dtype
        keys = _key_source(rng) if train and self.dropout > 0 else None
        h = x
        for l, block in enumerate(blocks):
            _, d_out, last = self.dims[l]
            p = self.layer_params(l)
            h = h.to(cd)
            S_, k_ = block.neigh_mask.shape
            x_dst, x_n = h[:S_], self._neighbours(h, block, l, contiguous_first)
            with trace.span("forward.attention", layer=l):
                out = self._attend(p, x_dst, x_n, block, l).float()
                b_v = p["b"][H * d_out : 2 * H * d_out]
                m = out + b_v * block.neigh_mask.any(1, keepdim=True)  # b_v where some slot is valid
                if last:
                    m = m.reshape(S_, H, d_out).mean(1)
            if trace.enabled():
                trace.count("attn.slots", block.neigh_mask.sum())
                trace.count("attn.slot_alloc", S_ * k_)
            with trace.span("forward.gate", layer=l):
                h = self._gate(p, x_dst, m, d_out, last)
            if not last and keys is not None:
                h = _dropout(h, keys(h.shape[0], h.device), self.dropout)
            h = h.to(x.dtype)
        return h
