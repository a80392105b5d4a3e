"""GraphSAGE with the mean aggregator (Hamilton et al., arXiv:1706.02216),
plain float32, per layer:
``out = h_dst @ W_self + mean_valid(h[neigh]) @ W_neigh + b``, ReLU and
dropout after each hidden layer.  Parameters ``w_self``/``w_neigh``
[d_in, d_out] and ``b`` a layer."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from gnnbench.reference.models import Quant, dropout, edge_rows, identity, slot_mean


def layer_dims(cfg: Dict) -> List[Tuple[int, int]]:
    """``(d_in, d_out)`` of every layer, input-first."""
    m, g = cfg["model"], cfg["graph"]
    L, hid = m["num_layers"], m["hidden"]
    return [(g["feature_dim"] if l == 0 else hid, g["num_classes"] if l == L - 1 else hid) for l in range(L)]


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for l, (a, b) in enumerate(layer_dims(cfg)):
        shapes.update({f"layer{l}.w_self": (a, b), f"layer{l}.w_neigh": (a, b), f"layer{l}.b": (b,)})
    return shapes


def forward(params: Dict, blocks: Sequence, x, drop_keys: Sequence, cfg: Dict, q: Quant = identity):
    """Logits of the mini-batch; ``blocks`` input-first."""
    rate = cfg["model"]["dropout"]
    h = q(x)
    n = len(blocks)
    for l, blk in enumerate(blocks):
        S = blk.neigh_slots.shape[0]
        h_mean = slot_mean(h, blk.neigh_slots, blk.neigh_mask)
        out = (q(h[:S]) @ q(params[f"layer{l}.w_self"]) + q(h_mean) @ q(params[f"layer{l}.w_neigh"])
               + params[f"layer{l}.b"])
        if l != n - 1:
            out = torch.relu(out)
            if rate > 0:
                out = dropout(out, drop_keys[l], rate)
        h = q(out)
    return h


def full(params: Dict, indptr, indices, x, cfg: Dict, q: Quant = identity, edge_chunk: int = 1 << 21):
    """Every node with its whole in-neighbourhood, layer by layer: [N, C]."""
    n = indptr.shape[0] - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    rows = edge_rows(indptr)
    h = q(x.float())
    L = cfg["model"]["num_layers"]
    for l in range(L):
        acc = torch.zeros((n, h.shape[1]), dtype=torch.float32, device=x.device)
        for b0 in range(0, indices.shape[0], edge_chunk):
            acc.index_add_(0, rows[b0 : b0 + edge_chunk], h[indices[b0 : b0 + edge_chunk].long()])
        mean = acc / torch.clamp(deg, min=1).float()[:, None]
        del acc
        out = (q(h) @ q(params[f"layer{l}.w_self"]) + q(mean) @ q(params[f"layer{l}.w_neigh"])
               + params[f"layer{l}.b"])
        del mean
        if l != L - 1:
            out = torch.relu(out)
        h = q(out)
    return h


# ---- model operations ----------------------------------------------------------
#
# Counted from the valid rows and slots of each layer (padding does no model
# work).  A product of [S, a] and [a, b] is 2 S a b operations; a mean over V
# valid slots of width a is V a additions.  Training counts the forward pass,
# the weights' gradients, and the inputs' gradients of every layer but the
# first (the features take no gradient).


def train_flops(cfg: Dict, rows: Sequence[int], slots: Sequence[int]) -> float:
    """One step's operations; ``rows``/``slots`` input-first like the layers."""
    total = 0.0
    for l, ((a, b), s, v) in enumerate(zip(layer_dims(cfg), rows, slots)):
        mm = 2 * 2 * s * a * b  # h_dst @ W_self and mean @ W_neigh
        total += mm + v * a  # forward
        total += mm  # the weights' gradients
        if l > 0:
            total += mm + v * a  # the inputs' gradients
    return total


def full_flops(cfg: Dict, num_nodes: int, num_edges: int) -> float:
    """One full pass's operations."""
    return sum(2 * 2 * num_nodes * a * b + num_edges * a for a, b in layer_dims(cfg))
