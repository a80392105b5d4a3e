"""GCN (Kipf & Welling) over static padded blocks.

Counterpart of ``dist_gnn_tpu/models/gcn.py`` as an ``nn.Module`` with the
forward contract of the port's ``SAGE`` and ``GAT``.  Per layer, on a
sampled block:

    h_i = act( ( sum_{j in N(i)} h_j / sqrt((deg_i+1)(deg_j+1))
                 + h_i / (deg_i+1) ) @ W + b )

Degrees are the valid sampled slots of a row + 1 (the self loop).  A
source row's degree is its block degree when it is also a destination row
(the first S frontier rows) and 1 otherwise.  With the dedup-free last hop
(``Trainer(dedup_last=False)``) no neighbour maps onto a destination slot,
so a neighbour that equals a seed gets degree 1 there instead of the
seed's block degree: a different, still valid, mini-batch normalisation
that the JAX package has too (its ``trainer.py:113-119``), kept as it is.

Parameters keep the JAX names and layout, ``layer{l}.w`` [d_in, d_out]
and ``layer{l}.b``, f32, so ``weights.gcn_params_from_jax`` maps one onto
the other by name.  The neighbour sum is plain PyTorch, as it is jnp in the
JAX package (no Pallas kernel); on the card only the trainer's feature
gather (K1) is a kernel of this model's path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from dist_gnn_tpu_torch.models.sage import _dropout, _glorot, _key_source
from dist_gnn_tpu_torch.sampler import Block
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


class GCN(nn.Module):
    def __init__(
        self,
        in_feats: int,
        n_hidden: int,
        n_classes: int,
        num_layers: int,
        dropout: float = 0.5,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """Glorot-uniform f32 weights and zero biases, drawn on the CPU from
        ``generator`` (a fresh unseeded one if None), then placed on
        ``device`` (default: the card).  ``dropout`` is the rate after each
        hidden layer in train mode."""
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.dims: List[tuple] = []
        for l in range(num_layers):
            d_in = in_feats if l == 0 else n_hidden
            d_out = n_classes if l == num_layers - 1 else n_hidden
            self.dims.append((d_in, d_out))
            layer = nn.ParameterDict(
                {"w": nn.Parameter(_glorot((d_in, d_out), gen)), "b": nn.Parameter(torch.zeros(d_out))}
            )
            self.add_module(f"layer{l}", layer.to(dev))
        self.dropout = dropout
        self.compute_dtype = compute_dtype

    def layer_params(self, l: int) -> nn.ParameterDict:
        return getattr(self, f"layer{l}")

    @staticmethod
    def _layer_forward(p, agg: torch.Tensor, w_dtype: Optional[torch.dtype]) -> torch.Tensor:
        """``agg @ W + b`` in agg's dtype: W cast to ``w_dtype`` (kept f32
        when None), the product in the promoted dtype as ``jnp.dot``
        promotes, accumulated in f32, the bias added in f32 and the sum
        rounded once."""
        w = p["w"] if w_dtype is None else p["w"].to(w_dtype)
        ct = torch.promote_types(agg.dtype, w.dtype)
        return ((agg.to(ct) @ w.to(ct)).float() + p["b"]).to(agg.dtype)

    @staticmethod
    def _aggregate(h: torch.Tensor, block: Block, contiguous: bool) -> torch.Tensor:
        """Symmetric-normalised neighbour sum + self loop: [S, F] in h's
        dtype (gcn.py:59-87)."""
        S = block.num_dst
        S_, k_ = block.neigh_mask.shape
        deg_dst = torch.sum(block.neigh_mask, dim=1).to(h.dtype) + 1  # [S]
        src_deg = torch.cat([deg_dst, torch.ones(block.num_src - S, dtype=h.dtype, device=h.device)])
        d_j = src_deg[torch.where(block.neigh_mask, block.neigh_slots, 0).long()]
        coef = block.neigh_mask.to(h.dtype) / torch.sqrt(deg_dst[:, None] * d_j)
        if contiguous:
            # k-major dedup-free hop: [k, S, F] with per-k contiguous rows
            nb = h[S:].reshape(k_, S_, h.shape[1])
            agg = torch.sum(nb * coef.T[..., None], dim=0)
        else:
            nb = h[block.neigh_slots.long()]  # [S, k, F]
            agg = torch.sum(nb * coef[..., None], dim=1)
        return agg + h[:S] / deg_dst[:, None]

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
        features of ``blocks[0]``'s frontier.  Returns logits for
        ``blocks[-1]``'s seeds, in the compute dtype (x's when None).

        ``train`` turns dropout on after every hidden layer's ReLU; its row
        keys come from ``rng``: a ``torch.Generator``, or a sequence of
        [S_l] key tensors, one per hidden layer (how tests inject the JAX
        keys).  ``contiguous_first``: the first block came from a
        dedup-free hop."""
        if len(blocks) != len(self.dims):
            raise ValueError(f"{len(blocks)} blocks for a {len(self.dims)}-layer model")
        cd = self.compute_dtype
        keys = _key_source(rng) if train and self.dropout > 0 else None
        h = x if cd is None else x.to(cd)
        for l, block in enumerate(blocks):
            p = self.layer_params(l)
            agg = self._aggregate(h, block, contiguous=(l == 0 and contiguous_first))
            h = self._layer_forward(p, agg, cd)
            if l != len(self.dims) - 1:
                h = torch.relu(h)
                if keys is not None:
                    h = _dropout(h, keys(h.shape[0], h.device), self.dropout)
        return h
