"""GAT (Velickovic et al., arXiv:1710.10903), plain float32, per layer and
head ``h``: ``e_ij = leaky_relu(a_l . W x_i + a_r . W x_j)`` over the
in-neighbours ``j`` of ``i``, ``alpha = softmax_j(e)`` (a row with no
neighbour gives 0), ``out_i = sum_j alpha_ij W x_j``; hidden layers
concatenate the heads, add the bias and take ELU, then dropout; the last
layer averages the heads and adds the heads' mean bias.  Parameters ``w``
[d_in, H*D], ``a_l``/``a_r`` [H, D] and ``b`` [H*D] a layer."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gnnbench.reference.models import Quant, dropout, edge_rows, identity


def layer_dims(cfg: Dict) -> List[Tuple[int, int]]:
    """``(d_in, d_out per head)`` of every layer, input-first."""
    m, g = cfg["model"], cfg["graph"]
    L, hid = m["num_layers"], m["hidden"]
    width = hid * m["heads"]
    return [(g["feature_dim"] if l == 0 else width, g["num_classes"] if l == L - 1 else hid) for l in range(L)]


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    H = cfg["model"]["heads"]
    shapes = {}
    for l, (a, b) in enumerate(layer_dims(cfg)):
        shapes.update({f"layer{l}.w": (a, H * b), f"layer{l}.a_l": (H, b), f"layer{l}.a_r": (H, b),
                       f"layer{l}.b": (H * b,)})
    return shapes


def _combine(out, b, heads: int, last: bool):
    """``out`` [S, H, D]: the last layer's head mean plus the heads' mean
    bias, or a hidden layer's ELU of the concatenated heads plus the bias."""
    S, _, D = out.shape
    if last:
        return out.mean(1) + b.reshape(heads, D).mean(0)
    return F.elu(out.reshape(S, heads * D) + b)


def forward(params: Dict, blocks: Sequence, x, drop_keys: Sequence, cfg: Dict, q: Quant = identity):
    """Logits of the mini-batch; ``blocks`` input-first.  The weighted sum
    is taken over the inputs and projected once (the same sum)."""
    m = cfg["model"]
    heads, rate, slope = m["heads"], m["dropout"], m["negative_slope"]
    h = x
    n = len(blocks)
    for l, blk in enumerate(blocks):
        h = q(h)
        S, k = blk.neigh_slots.shape
        w = q(params[f"layer{l}.w"])
        d_in = w.shape[0]
        D = w.shape[1] // heads
        w3 = w.reshape(d_in, heads, D)
        wal = torch.einsum("ehd,hd->eh", w3, params[f"layer{l}.a_l"])
        war = torch.einsum("ehd,hd->eh", w3, params[f"layer{l}.a_r"])
        x_n = h[blk.neigh_slots.long()]  # [S, k, d_in]
        el = h[:S] @ wal  # [S, H]
        er = x_n @ war  # [S, k, H]
        e = F.leaky_relu(el[:, None, :] + er, slope)
        mask = blk.neigh_mask[..., None]
        alpha = torch.softmax(e.masked_fill(~mask, -1e30), dim=1)
        alpha = torch.where(mask, alpha, 0.0)
        agg = torch.einsum("skh,ske->she", alpha, x_n)  # [S, H, d_in]
        out = torch.einsum("she,ehd->shd", agg, w3)  # [S, H, D]
        h = _combine(out, params[f"layer{l}.b"], heads, l == n - 1)
        if l != n - 1 and rate > 0:
            h = dropout(h, drop_keys[l], rate)
    return q(h)


def full(params: Dict, indptr, indices, x, cfg: Dict, q: Quant = identity, edge_chunk: int = 1 << 20):
    """Every node with its whole in-neighbourhood, layer by layer: [N, C].
    Each layer projects every node, takes each row's largest score per head
    over its edges, then sums the exponentials and the weighted rows."""
    m = cfg["model"]
    heads, slope = m["heads"], m["negative_slope"]
    n = indptr.shape[0] - 1
    rows = edge_rows(indptr)
    h = x.float()
    L = m["num_layers"]
    for l in range(L):
        h = q(h)
        w = q(params[f"layer{l}.w"])
        D = w.shape[1] // heads
        z = (h @ w).reshape(n, heads, D)
        el = torch.einsum("nhd,hd->nh", z, params[f"layer{l}.a_l"])
        er = torch.einsum("nhd,hd->nh", z, params[f"layer{l}.a_r"])
        chunks = [(rows[b0 : b0 + edge_chunk], indices[b0 : b0 + edge_chunk].long())
                  for b0 in range(0, indices.shape[0], edge_chunk)]
        top = torch.full((n, heads), float("-inf"), device=x.device)
        for r, s in chunks:
            top.scatter_reduce_(0, r[:, None].expand(-1, heads), F.leaky_relu(el[r] + er[s], slope), "amax")
        den = torch.zeros((n, heads), device=x.device)
        acc = torch.zeros((n, heads, D), device=x.device)
        for r, s in chunks:
            p = torch.exp(F.leaky_relu(el[r] + er[s], slope) - top[r])
            den.index_add_(0, r, p)
            acc.index_add_(0, r, p[..., None] * z[s])
        out = acc / torch.clamp(den, min=1e-30)[..., None]  # a row with no edge keeps 0
        del acc, den, top, z
        h = _combine(out, params[f"layer{l}.b"], heads, l == L - 1)
    return q(h)


# ---- model operations ----------------------------------------------------------
#
# Counted from the valid rows and slots of each layer, as the reference's
# forward takes them: the scores (el over the rows, er over the slots), the
# weighted sums over the slots, one projection a row.  Training counts the
# forward pass, the weights' and the scores' gradients, and the inputs'
# gradients of every layer but the first.


def train_flops(cfg: Dict, rows: Sequence[int], slots: Sequence[int]) -> float:
    heads = cfg["model"]["heads"]
    total = 0.0
    for l, ((e, d), s, v) in enumerate(zip(layer_dims(cfg), rows, slots)):
        hd = heads * d
        score = 2 * s * e * heads + 2 * v * e * heads  # el, er
        agg = 2 * v * e * heads  # the weighted sums
        proj = 2 * s * e * hd
        total += score + agg + proj  # forward
        total += proj + agg + score  # the weights' and the scores' gradients
        if l > 0:
            total += proj + agg + score  # the inputs' gradients
    return total


def full_flops(cfg: Dict, num_nodes: int, num_edges: int) -> float:
    """One full pass, projection first: the projection of every node, its
    two scores a head, and the weighted sum of projected rows over every
    edge."""
    heads = cfg["model"]["heads"]
    total = 0.0
    for e, d in layer_dims(cfg):
        hd = heads * d
        total += 2 * num_nodes * e * hd + 2 * 2 * num_nodes * hd + 2 * num_edges * hd
    return total
