"""GraphSAGE (mean aggregator) over static padded blocks.

Counterpart of ``dist_gnn_tpu/models/sage.py`` as an ``nn.Module``:

    h_dst = h_src[:S]                      (seeds-first frontier invariant)
    out   = h_dst @ W_self + mean_valid(neigh) @ W_neigh + b

Parameters keep the JAX layout — ``layer{l}.w_self`` and ``w_neigh`` as
``[d_in, d_out]``, and ``layer{l}.b`` — so ``weights.sage_params_from_jax``
maps one onto the other by name.  Params are f32; with ``compute_dtype``
the activations and the matmul operands are cast to it.

On CUDA every layer's neighbour mean is the K3 kernel, the dedup-free
first layer too (its slots ``S + j*B + i`` are explicit in the block).  On
the CPU that layer takes :func:`contiguous_mean`, the JAX package's
reshape-sum, and the others ``spmm.gather_mean``.  K3 is differentiable
(its backward is a kernel too), so training reaches every layer.  In train
mode, dropout follows the ReLU of every hidden layer, with one uint32 key
per row (``prng.dropout_keep``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from dist_gnn_tpu_torch.ops import prng
from dist_gnn_tpu_torch.ops.gather import gather_mean
from dist_gnn_tpu_torch.sampler import Block
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = shape
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2 * u - 1) * limit).to(torch.float32)


def _key_source(rng) -> Callable[[int, torch.device], torch.Tensor]:
    """Dropout row keys, one call per dropout layer: drawn from a
    ``torch.Generator``, or taken in order from a sequence of injected
    [S_l] key tensors."""
    if isinstance(rng, torch.Generator):
        return lambda S, device: prng.random_keys(rng, (S,), device)
    if rng is None:
        raise ValueError("train mode with dropout needs rng: a torch.Generator or row keys")
    it = iter(rng)
    return lambda S, device: next(it).to(device)


def _dropout(h: torch.Tensor, row_keys: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate, scale by 1/(1 - rate)."""
    keep = prng.dropout_keep(row_keys, h.shape, 1.0 - rate)
    return torch.where(keep, h / (1.0 - rate), 0)


def contiguous_mean(h: torch.Tensor, block: Block) -> torch.Tensor:
    """Plain neighbour mean of a dedup-free k-major block
    (``sampler._no_dedup_block``): the frontier tail reshapes to
    ``[k, B, F]`` and the masked sum runs over the leading axis."""
    B, k = block.neigh_mask.shape
    nb = h[block.num_dst :].reshape(k, B, h.shape[1])
    m = block.neigh_mask.T[..., None].to(h.dtype)
    cnt = torch.sum(block.neigh_mask, dim=1, dtype=h.dtype)[:, None]
    return torch.sum(nb * m, dim=0) / torch.clamp(cnt, min=1)


class SAGE(nn.Module):
    def __init__(
        self,
        in_feats: int,
        n_hidden: int,
        n_classes: int,
        num_layers: int,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        dropout: float = 0.5,
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
                {
                    "w_self": nn.Parameter(_glorot((d_in, d_out), gen)),
                    "w_neigh": nn.Parameter(_glorot((d_in, d_out), gen)),
                    "b": nn.Parameter(torch.zeros(d_out)),
                }
            )
            self.add_module(f"layer{l}", layer.to(dev))
        self.compute_dtype = compute_dtype
        self.dropout = dropout

    def layer_params(self, l: int) -> nn.ParameterDict:
        return getattr(self, f"layer{l}")

    def _layer_forward(self, p, h_dst: torch.Tensor, h_mean: torch.Tensor) -> torch.Tensor:
        """One SAGEConv-mean layer given the destination features and the
        aggregated neighbour mean (shared by block serving and full-graph
        inference).  The two products and the bias are summed in f32 and
        rounded once to the compute dtype."""
        cd = self.compute_dtype
        w_self, w_neigh = p["w_self"], p["w_neigh"]
        if cd is not None:
            h_dst, h_mean = h_dst.to(cd), h_mean.to(cd)
            w_self, w_neigh = w_self.to(cd), w_neigh.to(cd)
        out = (
            (h_dst @ w_self).float()
            + (h_mean @ w_neigh).float()
            + p["b"].float()
        )
        return out.to(h_dst.dtype if cd is None else cd)

    def forward(
        self,
        blocks: Sequence[Block],
        x: torch.Tensor,  # [cap_deepest_frontier, in_feats]
        *,
        train: bool = False,
        rng=None,
        contiguous_first: bool = False,
    ) -> torch.Tensor:
        """``blocks`` are ordered input-first (deepest layer first), i.e.
        ``reversed(sampler output)``; ``x`` holds the features of
        ``blocks[0]``'s frontier.  Returns logits for ``blocks[-1]``'s
        seeds (the mini-batch).

        ``train`` turns dropout on; its row keys come from ``rng``: a
        ``torch.Generator``, or a sequence of [S_l] key tensors, one per
        hidden layer (how tests inject the JAX keys).
        ``contiguous_first``: the first block came from a dedup-free hop
        (``sampler._no_dedup_block``)."""
        if len(blocks) != len(self.dims):
            raise ValueError(f"{len(blocks)} blocks for a {len(self.dims)}-layer model")
        cd = self.compute_dtype
        keys = _key_source(rng) if train and self.dropout > 0 else None
        h = x if cd is None else x.to(cd)
        for l, block in enumerate(blocks):
            h_dst = h[: block.num_dst]
            if l == 0 and contiguous_first and h.device.type == "cpu":
                h_mean = contiguous_mean(h, block)
            else:
                h_mean = gather_mean(h, block.neigh_slots, block.neigh_mask)
            h = self._layer_forward(self.layer_params(l), h_dst, h_mean).to(h.dtype)
            if l != len(self.dims) - 1:
                h = torch.relu(h)
                if keys is not None:
                    h = _dropout(h, keys(h.shape[0], h.device), self.dropout)
        return h
