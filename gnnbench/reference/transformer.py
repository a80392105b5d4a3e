"""A graph transformer: UniMP's attention layer with a gated residual (Shi
et al., arXiv:2009.03509; PyG's ``TransformerConv(beta=True)``), plain
float32, per layer, with H heads of width D over row i's valid sampled
neighbours j:

    q_ih = W_q,h x_i + b_q,h,  k_jh = W_k,h x_j,  v_jh = W_v,h x_j + b_v,h
    alpha_ijh = softmax_j(q_ih . k_jh / sqrt(D))
    m_i = concat_h sum_j alpha_ijh v_jh  (the last layer: the heads' mean;
                                          a row with no valid neighbour: 0)
    r_i = W_s x_i + b_s
    beta_i = sigmoid(w_g . [m_i ; r_i ; m_i - r_i])
    o_i = beta_i r_i + (1 - beta_i) m_i

Hidden layers then take ReLU(LayerNorm(o_i)) (scale ``1 + ln_s``, bias
``ln_b``, eps 1e-5) and dropout; the last layer's ``o_i`` are the logits.
Every slot's key and value are projected and the softmax is masked: the
unfolded form, independent of the program's folding of the query through
W_k.  Parameters a layer: ``w`` [d_in, 3*H*D] (q, k, v), ``w_self`` [d_in,
width], ``b`` [2*H*D + width] (b_q, b_v, b_s), ``g`` [3*width], and on hidden
layers ``ln_s``, ``ln_b`` [width]; width is H*D on hidden layers and D on
the last.  No key bias (the softmax cancels it), no dropout on the
attention weights and no masked label input (the configuration's
``assumed`` lists them)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gnnbench.reference.models import Quant, dropout, identity

LN_EPS = 1e-5


def layer_dims(cfg: Dict) -> List[Tuple[int, int]]:
    """``(d_in, d_out per head)`` of every layer, input-first."""
    m, g = cfg["model"], cfg["graph"]
    L, hid = m["num_layers"], m["hidden"]
    width = hid * m["heads"]
    return [(g["feature_dim"] if l == 0 else width, g["num_classes"] if l == L - 1 else hid) for l in range(L)]


def widths(cfg: Dict) -> List[int]:
    """The width of every layer's output: H*D on hidden layers, D on the
    last."""
    H = cfg["model"]["heads"]
    dims = layer_dims(cfg)
    return [d if l == len(dims) - 1 else H * d for l, (_, d) in enumerate(dims)]


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    H = cfg["model"]["heads"]
    dims = layer_dims(cfg)
    shapes = {}
    for l, ((a, d), width) in enumerate(zip(dims, widths(cfg))):
        shapes.update({f"layer{l}.w": (a, 3 * H * d), f"layer{l}.w_self": (a, width),
                       f"layer{l}.b": (2 * H * d + width,), f"layer{l}.g": (3 * width,)})
        if l != len(dims) - 1:
            shapes.update({f"layer{l}.ln_s": (width,), f"layer{l}.ln_b": (width,)})
    return shapes


def forward(params: Dict, blocks: Sequence, x, drop_keys: Sequence, cfg: Dict, q: Quant = identity):
    """Logits of the mini-batch; ``blocks`` input-first."""
    m = cfg["model"]
    heads, rate = m["heads"], m["dropout"]
    h = x
    n = len(blocks)
    for l, blk in enumerate(blocks):
        h = q(h)
        S, k = blk.neigh_slots.shape
        w = q(params[f"layer{l}.w"])
        d_in = w.shape[0]
        D = w.shape[1] // (3 * heads)
        HD = heads * D
        b = params[f"layer{l}.b"]
        x_i = h[:S]
        x_j = h[blk.neigh_slots.long()]  # [S, k, d_in]
        qv = (x_i @ w[:, :HD] + b[:HD]).reshape(S, heads, D)
        kv = (x_j @ w[:, HD : 2 * HD]).reshape(S, k, heads, D)
        vv = (x_j @ w[:, 2 * HD :] + b[HD : 2 * HD]).reshape(S, k, heads, D)
        score = torch.einsum("shd,skhd->skh", qv, kv) / math.sqrt(D)
        mask = blk.neigh_mask[..., None]
        alpha = torch.softmax(score.masked_fill(~mask, -1e30), dim=1)
        alpha = torch.where(mask, alpha, 0.0)
        msg = torch.einsum("skh,skhd->shd", alpha, vv)  # [S, H, D]
        msg = msg.mean(1) if l == n - 1 else msg.reshape(S, HD)
        r = x_i @ q(params[f"layer{l}.w_self"]) + b[2 * HD :]
        beta = torch.sigmoid(torch.cat([msg, r, msg - r], dim=1) @ params[f"layer{l}.g"])[:, None]
        h = beta * r + (1 - beta) * msg
        if l != n - 1:
            width = h.shape[1]
            h = F.relu(F.layer_norm(h, (width,), 1 + params[f"layer{l}.ln_s"], params[f"layer{l}.ln_b"], LN_EPS))
            if rate > 0:
                h = dropout(h, drop_keys[l], rate)
    return q(h)


def full(params: Dict, indptr, indices, x, cfg: Dict, q: Quant = identity, edge_chunk: int = 1 << 20):
    raise NotImplementedError("the transformer family has no full-graph pass: neither the program's "
                              "full_graph_inference nor this reference computes one")


# ---- model operations ----------------------------------------------------------
#
# Counted from the valid rows and slots of each layer in the cheapest form of
# the layer: the query over the rows, its fold through W_k, the scores and the
# weighted sums over the slots, one value projection a row (the weighted sum
# taken over the inputs), the root term and the gate.  Training counts the
# forward pass, the weights' and the scores' gradients, and the inputs'
# gradients of every layer but the first, as the GAT reference counts them.


def layer_flops(e: int, d: int, heads: int, width: int, rows: int, slots: int) -> float:
    """The forward operations of one layer of ``rows`` valid rows and
    ``slots`` valid slots, input width ``e``, ``heads`` heads of ``d``."""
    hd = heads * d
    query = 2 * rows * e * hd
    fold = 2 * rows * hd * e
    score = 2 * slots * e * heads
    agg = 2 * slots * e * heads
    proj = 2 * rows * e * hd
    root = 2 * rows * e * width
    gate = 2 * rows * 3 * width
    return query + fold + score + agg + proj + root + gate


def train_flops(cfg: Dict, rows: Sequence[int], slots: Sequence[int]) -> float:
    heads = cfg["model"]["heads"]
    total = 0.0
    for l, ((e, d), width, s, v) in enumerate(zip(layer_dims(cfg), widths(cfg), rows, slots)):
        fwd = layer_flops(e, d, heads, width, s, v)
        total += fwd * (2 if l == 0 else 3)
    return total


def full_flops(cfg: Dict, num_nodes: int, num_edges: int) -> float:
    raise NotImplementedError("the transformer family has no full-graph pass")
