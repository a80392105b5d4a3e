"""The graph transformer (UniMP's attention layer with a gated residual):
the port's model, its attention op (K9's and K4/K5's plain versions) and
its spans, against the benchmark's plain float32 reference
(``gnnbench/reference/transformer.py``) and against autograd of the
unfolded formula.  The JAX package has no such model, so nothing here
imports it.

Everything is float32 on the CPU, at E=12, H=2, D=8 and fanout (3, 2).
Tolerances: 1e-5 for values and 1e-4 for gradients (the two sides differ
in summation order and in folding the query through W_k; no rounding to a
lower precision on either side).  The CUDA kernels
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dist_gnn_tpu_torch.graph import Graph  # noqa: E402
from dist_gnn_tpu_torch.models.transformer import GraphTransformer  # noqa: E402
from dist_gnn_tpu_torch.ops import attention as attn_ops  # noqa: E402
from dist_gnn_tpu_torch.ops import gat as gat_ops  # noqa: E402
from dist_gnn_tpu_torch.ops.spmm import masked_segment_softmax  # noqa: E402
from dist_gnn_tpu_torch.sampler import Block, sample_blocks  # noqa: E402
from dist_gnn_tpu_torch.training.trainer import Trainer  # noqa: E402
from dist_gnn_tpu_torch.utils import trace  # noqa: E402
from gnnbench.reference import models as ref_models  # noqa: E402

torch.set_num_threads(1)
E, H, D, C = 12, 2, 8, 5
FANOUT = (3, 2)
N, B = 120, 16
CFG = {"model": {"family": "transformer", "num_layers": 2, "hidden": D, "heads": H, "dropout": 0.5},
       "graph": {"feature_dim": E, "num_classes": C}}
RTOL_V, RTOL_G = 1e-5, 1e-4


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, N)
    deg[3] = 0  # a node with no in-edge: its rows have no valid slot
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    return Graph(indptr=ip, indices=ix, probs=None, num_nodes=N, num_edges=ix.numel(), max_degree=int(deg.max()))


@pytest.fixture(scope="module")
def data():
    g = _graph()
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(N, E, generator=gen)
    labels = torch.randint(0, C, (N,), generator=gen, dtype=torch.int32)
    return g, feats, labels


def _weights(seed=3):
    """Seeded random weights in the model's layout, every one nonzero (the
    benchmark's zero starts would leave the gate and LayerNorm paths
    untested)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ref_models.family("transformer").param_shapes(CFG)
    return {k: torch.randn(s, generator=gen) * (0.3 if k.endswith((".w", ".w_self")) else 0.1)
            for k, s in shapes.items()}


def _model(weights=None):
    m = GraphTransformer(E, D, C, 2, num_heads=H, dropout=0.5, device="cpu")
    m.load_state_dict(weights if weights is not None else _weights())
    return m


def _batch(data, seed=5, dedup_last=False):
    g, feats, _ = data
    gen = torch.Generator().manual_seed(seed)
    seeds = torch.randperm(N, generator=gen)[:B].to(torch.int32)
    seeds[0] = 3  # a seed with no in-neighbour
    mask = torch.ones(B, dtype=torch.bool)
    mask[-2:] = False
    blocks, _ = sample_blocks(g, seeds, mask, FANOUT, False, gen, dedup_last=dedup_last)
    blocks = tuple(reversed(blocks))
    x = feats[torch.where(blocks[0].frontier_mask, blocks[0].frontier, 0).long()]
    drops = [torch.randint(0, 2**32, (b.num_dst,), generator=gen, dtype=torch.int64) for b in blocks[:-1]]
    return seeds, mask, blocks, x, drops


def _ref_step(weights, blocks, x, drops, labels, mask):
    return ref_models.train_step(CFG, weights, list(blocks), x, labels, mask, drops)


# the first hop as the sampler lays it out: dedup-free (a free reshape) or deduplicated (gathered)
LAYOUTS = pytest.mark.parametrize("dedup_last", [False, True], ids=["dedup_free", "deduped"])


@LAYOUTS
def test_model_matches_the_reference(data, dedup_last):
    """Logits, loss and every leaf's gradient against the plain reference,
    dropout on (the same row keys)."""
    _, _, labels = data
    seeds, mask, blocks, x, drops = _batch(data, dedup_last=dedup_last)
    w = _weights()
    y = torch.where(mask, labels[torch.where(mask, seeds, 0).long()], 0)
    loss_r, grads_r, logits_r = _ref_step(w, blocks, x, drops, y, mask)
    m = _model(w)
    logits = m(blocks, x, train=True, rng=list(drops), contiguous_first=not dedup_last)
    torch.testing.assert_close(logits, logits_r, rtol=RTOL_V, atol=RTOL_V)
    loss = ref_models.masked_nll(logits, y, mask)
    assert float(loss.detach()) == pytest.approx(loss_r, rel=RTOL_V)
    loss.backward()
    for name, p in m.named_parameters():
        torch.testing.assert_close(p.grad, grads_r[name], rtol=RTOL_G, atol=RTOL_G, msg=name)
        assert p.grad.abs().max() > 0, name


@LAYOUTS
def test_three_adam_steps_through_the_trainer(data, dedup_last):
    """Three ``Trainer.train_step`` calls against the reference's samples
    and Adam: losses and parameters."""
    g, feats, labels = data
    w = _weights()
    m = _model(w)
    tr = Trainer(m, fan_out=FANOUT, lr=1e-2, weight_decay=5e-4, replace=False, dedup_last=dedup_last, device="cpu")
    opt = ref_models.Adam(w, 1e-2, 5e-4)
    params = dict(w)
    for step in range(3):
        seeds, mask, blocks, x, drops = _batch(data, seed=10 + step)
        hop_keys = [torch.randint(0, 2**32, (s.num_dst,), generator=torch.Generator().manual_seed(step),
                                  dtype=torch.int64) for s in reversed(blocks)]
        got = tr.train_step(g, feats, labels, seeds, mask, (hop_keys, list(drops)))
        blocks_p, _ = sample_blocks(g, seeds, mask, FANOUT, False, hop_keys, dedup_last=dedup_last)
        blocks_p = list(reversed(blocks_p))
        x_p = feats[torch.where(blocks_p[0].frontier_mask, blocks_p[0].frontier, 0).long()]
        y = torch.where(mask, labels[torch.where(mask, seeds, 0).long()], 0)
        loss_r, grads_r, _ = _ref_step(params, blocks_p, x_p, drops, y, mask)
        assert float(got["loss"]) == pytest.approx(loss_r, rel=RTOL_G)
        params = opt.step(params, grads_r)
    for name, p in m.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], rtol=RTOL_G, atol=RTOL_G, msg=name)


def _block(S, k, mask):
    """A block of S destination rows whose slots point past them, S + j*S + i
    (the dedup-free layout), with ``mask``."""
    slots = (S + torch.arange(k)[None, :] * S + torch.arange(S)[:, None]).to(torch.int32)
    frontier = torch.arange(S * (k + 1), dtype=torch.int32)
    return Block(seeds=frontier[:S], seed_mask=torch.ones(S, dtype=torch.bool), frontier=frontier,
                 frontier_mask=torch.ones(S * (k + 1), dtype=torch.bool),
                 num_frontier=torch.tensor(S * (k + 1)), neigh_slots=slots, neigh_mask=mask)


@pytest.mark.parametrize("contiguous", [True, False], ids=["reshaped", "gathered"])
def test_a_row_with_no_valid_slot_gives_a_zero_message(contiguous):
    """Its message m is 0 (no b_v), so the layer's output is the gate's share
    of the root term alone: beta r with beta = sigmoid(w_g . [0; r; -r]);
    the slots read as a free reshape or gathered through ``neigh_slots``."""
    S, k = 6, 3
    gen = torch.Generator().manual_seed(2)
    mask = torch.rand(S, k, generator=gen) < 0.7
    mask[0] = mask[4] = False
    mask[1] = True
    blk = _block(S, k, mask)
    m = GraphTransformer(H * D, D, C, 1, num_heads=H, device="cpu")
    w = {k_: v for k_, v in _weights().items() if k_.startswith("layer1.")}  # the last layer's
    m.load_state_dict({k_.replace("layer1.", "layer0."): v for k_, v in w.items()})
    x = torch.randn(S * (k + 1), H * D, generator=gen)
    out = m((blk,), x, contiguous_first=contiguous)
    p = m.layer_params(0)
    r = x[:S] @ p["w_self"] + p["b"][2 * H * C :]
    g_m, g_r, g_d = p["g"].split(C)
    beta = torch.sigmoid(r @ (g_r - g_d))[:, None]
    torch.testing.assert_close(out[[0, 4]], (beta * r)[[0, 4]], rtol=RTOL_V, atol=RTOL_V)
    w3 = p["w"]
    msg = attn_ops.dot_attention(x[:S], x[S:].reshape(k, S, H * D), mask.float(), w3[:, : H * C],
                                 w3[:, H * C : 2 * H * C], w3[:, 2 * H * C :], p["b"][: H * C], H, True)
    assert torch.all(msg[[0, 4]] == 0) and torch.all(msg[1] != 0)


def test_the_last_layer_takes_the_heads_mean():
    """A last layer's message is the mean over heads of each head's
    softmax-weighted values plus b_v, written out head by head."""
    S, k = 5, 4
    gen = torch.Generator().manual_seed(4)
    mask = torch.rand(S, k, generator=gen) < 0.8
    mask[:, 0] = True
    blk = _block(S, k, mask)
    m = GraphTransformer(E, D, C, 1, num_heads=H, device="cpu")
    x = torch.randn(S * (k + 1), E, generator=gen)
    p = m.layer_params(0)
    with torch.no_grad():
        for v in p.values():
            v.copy_(torch.randn(v.shape, generator=gen) * 0.3)
    out = m((blk,), x, contiguous_first=True)
    HC = H * C
    xd, xn = x[:S], x[S:].reshape(k, S, E).transpose(0, 1)
    heads = []
    for h in range(H):
        cols = slice(h * C, (h + 1) * C)
        q = xd @ p["w"][:, :HC][:, cols] + p["b"][:HC][cols]
        keys = xn @ p["w"][:, HC : 2 * HC][:, cols]
        vals = xn @ p["w"][:, 2 * HC :][:, cols] + p["b"][HC : 2 * HC][cols]
        s = torch.einsum("sd,skd->sk", q, keys) / math.sqrt(C)
        a = torch.softmax(s.masked_fill(~mask, -1e30), dim=1)
        heads.append(torch.einsum("sk,skd->sd", a, vals))
    msg = torch.stack(heads).mean(0)
    r = xd @ p["w_self"] + p["b"][2 * HC :]
    beta = torch.sigmoid(torch.cat([msg, r, msg - r], 1) @ p["g"])[:, None]
    torch.testing.assert_close(out, beta * r + (1 - beta) * msg, rtol=RTOL_V, atol=RTOL_V)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_the_dedup_free_first_hop_equals_its_gathered_form(data, train):
    """The first block's free reshape (``contiguous_first``) gives what the
    gather of its explicit slots gives, gradients too, with dropout on and
    off."""
    _, _, blocks, x, drops = _batch(data)
    outs = []
    for contiguous in (True, False):
        m = _model()
        y = m(blocks, x, train=train, rng=list(drops), contiguous_first=contiguous)
        y.square().sum().backward()
        outs.append((y, {n: p.grad for n, p in m.named_parameters()}))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=RTOL_V, atol=RTOL_V)
    for n in outs[0][1]:
        torch.testing.assert_close(outs[0][1][n], outs[1][1][n], rtol=RTOL_G, atol=RTOL_G, msg=n)


def _score_inputs(seed, K, S, E_, H_, D_):
    gen = torch.Generator().manual_seed(seed)
    x_n = torch.randn(K, S, E_, generator=gen)
    x_d = torch.randn(S, E_, generator=gen)
    w_q = torch.randn(E_, H_ * D_, generator=gen) * 0.3
    w_k = torch.randn(E_, H_ * D_, generator=gen) * 0.3
    mask = torch.rand(S, K, generator=gen) < 0.75
    mask[0] = False
    mask[1] = True
    return x_n, x_d, w_q, w_k, mask


def _unfolded_scores(x_n, x_d, w_q, w_k, H_):
    """scale * q_ih . (W_k,h x_j) with every key projected: [K, S, H]."""
    K, S, E_ = x_n.shape
    D_ = w_q.shape[1] // H_
    q = (x_d @ w_q).reshape(S, H_, D_)
    keys = (x_n @ w_k).reshape(K, S, H_, D_)
    return torch.einsum("shd,kshd->ksh", q, keys) / math.sqrt(D_)


@pytest.mark.parametrize("K,S,E_,H_,D_", [(3, 7, 12, 2, 8), (5, 9, 33, 4, 6), (1, 4, 5, 1, 3)])
def test_k9_plain_is_the_folded_unfolded_score(K, S, E_, H_, D_):
    """K9's plain version on the folded query equals the unfolded scores
    less each row's and head's largest valid one; masked slots are 0."""
    x_n, x_d, w_q, w_k, mask = _score_inputs(K, K, S, E_, H_, D_)
    q = (x_d @ w_q).reshape(S, H_, D_)
    qt = torch.einsum("shd,ehd->hse", q, w_k.reshape(E_, H_, D_))
    got = attn_ops.score_fwd(x_n, qt.contiguous(), mask.float(), 1 / math.sqrt(D_))
    raw = _unfolded_scores(x_n, x_d, w_q, w_k, H_)
    valid = mask.T[:, :, None]
    top = torch.where(valid, raw, -1e30).amax(0, keepdim=True)
    torch.testing.assert_close(got, torch.where(valid, raw - top, 0.0), rtol=RTOL_V, atol=RTOL_V)
    # the folded form is the unfolded one before the shift, and the shift leaves the softmax alone
    folded = torch.einsum("kse,hse->ksh", x_n, qt) / math.sqrt(D_)
    torch.testing.assert_close(folded, raw, rtol=RTOL_V, atol=RTOL_V)
    a = masked_segment_softmax(got.permute(1, 0, 2), mask)
    b = masked_segment_softmax(raw.permute(1, 0, 2), mask)
    torch.testing.assert_close(a, b, rtol=RTOL_V, atol=RTOL_V)


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("K,S,E_,H_,D_", [(3, 7, 12, 2, 8), (6, 5, 20, 4, 4)])
def test_k9_bwd_plain_matches_autograd(K, S, E_, H_, D_, need_dx):
    """K9-bwd's plain version against autograd of the unshifted folded
    scores: the folded queries' gradient, and the inputs' added into the
    given d_x at the valid slots only."""
    x_n, x_d, w_q, w_k, mask = _score_inputs(2 * K, K, S, E_, H_, D_)
    qt = torch.randn(H_, S, E_, generator=torch.Generator().manual_seed(9))
    ds = torch.randn(K, S, H_, generator=torch.Generator().manual_seed(8))
    ds = torch.where(mask.T[:, :, None], ds, 0.0)  # K5 gives masked slots no gradient
    dxn0 = torch.randn(K, S, E_, generator=torch.Generator().manual_seed(7)) if need_dx else None
    xl, ql = x_n.clone().requires_grad_(True), qt.clone().requires_grad_(True)
    scale = 1 / math.sqrt(D_)
    s = torch.einsum("kse,hse->ksh", xl, ql) * scale
    (s * ds).sum().backward()
    dqt, dxn = attn_ops.score_bwd(x_n, qt, mask.float(), ds, dxn0.clone() if need_dx else None, scale)
    torch.testing.assert_close(dqt, ql.grad, rtol=RTOL_G, atol=RTOL_G)
    if need_dx:
        torch.testing.assert_close(dxn, dxn0 + xl.grad, rtol=RTOL_G, atol=RTOL_G)
        dead = ~mask.T  # a masked slot's d_x is K5's alone
        assert torch.equal(dxn[dead], dxn0[dead])
    else:
        assert dxn is None


@pytest.mark.parametrize("K,S,E_,H_,D_", [(3, 7, 12, 2, 8), (4, 6, 9, 3, 5)])
def test_k4_k5_plain_at_slope_one_are_a_plain_softmax(K, S, E_, H_, D_):
    """K4 and K5's plain versions with el = 0 and slope 1 are a masked
    softmax over each head's scores, the weighted sum and the projection;
    K5's score and input gradients are autograd's."""
    gen = torch.Generator().manual_seed(K + S)
    x_n = torch.randn(K, S, E_, generator=gen)
    s = torch.randn(K, S, H_, generator=gen)
    mask = torch.rand(S, K, generator=gen) < 0.7
    mask[0] = False
    w = torch.randn(E_, H_ * D_, generator=gen) * 0.3
    g = torch.randn(S, H_ * D_, generator=gen)
    el = torch.zeros(S, H_)
    got = gat_ops.gat_fwd(x_n, el, s, mask.float(), w, 1.0)
    xl, sl, wl = x_n.clone().requires_grad_(True), s.clone().requires_grad_(True), w.clone().requires_grad_(True)
    alpha = masked_segment_softmax(sl.permute(1, 0, 2), mask)  # [S, K, H]
    agg = torch.einsum("skh,kse->she", alpha, xl)
    want = torch.einsum("she,ehd->shd", agg, wl.reshape(E_, H_, D_)).reshape(S, H_ * D_)
    torch.testing.assert_close(got, want, rtol=RTOL_V, atol=RTOL_V)
    (want * g).sum().backward()
    dw, _, d_s, dxn = gat_ops.gat_bwd(x_n, el, s, mask.float(), w, g, 1.0, True)
    torch.testing.assert_close(dw, wl.grad, rtol=RTOL_G, atol=RTOL_G)
    torch.testing.assert_close(d_s, sl.grad, rtol=RTOL_G, atol=RTOL_G)
    torch.testing.assert_close(dxn, xl.grad, rtol=RTOL_G, atol=RTOL_G)


def test_dot_attention_matches_autograd_of_the_unfolded_formula():
    """The fused op (K9, K4, K5 and K9-bwd's plain versions) and its
    gradients against the unfolded formula under autograd."""
    K, S = 4, 9
    x_n, x_d, w_q, w_k, mask = _score_inputs(11, K, S, E, H, D)
    gen = torch.Generator().manual_seed(12)
    w_v = torch.randn(E, H * D, generator=gen) * 0.3
    b_q = torch.randn(H * D, generator=gen) * 0.1
    g = torch.randn(S, H * D, generator=gen)
    leaves = [t.clone().requires_grad_(True) for t in (x_d, x_n, w_q, w_k, w_v, b_q)]
    got = attn_ops.dot_attention(leaves[0], leaves[1], mask.float(), *leaves[2:5], leaves[5], H, True)
    (got * g).sum().backward()
    grads = [t.grad for t in leaves]
    ref = [t.clone().requires_grad_(True) for t in (x_d, x_n, w_q, w_k, w_v, b_q)]
    xd, xn, wq, wk, wv, bq = ref
    q = (xd @ wq + bq).reshape(S, H, D)
    keys = (xn @ wk).reshape(K, S, H, D)
    vals = (xn @ wv).reshape(K, S, H, D)
    alpha = masked_segment_softmax(torch.einsum("shd,kshd->skh", q, keys) / math.sqrt(D), mask)
    want = torch.einsum("skh,kshd->shd", alpha, vals).reshape(S, H * D)
    torch.testing.assert_close(got, want, rtol=RTOL_V, atol=RTOL_V)
    assert torch.all(got[0] == 0)
    (want * g).sum().backward()
    for a, t in zip(grads, ref):
        torch.testing.assert_close(a, t.grad, rtol=RTOL_G, atol=RTOL_G)


def test_attn_plan_refuses_what_the_kernels_do_not_take():
    assert attn_ops.attn_plan(5, 216_576, 100, 4, torch.bfloat16) == (8, 27_072)
    assert attn_ops.attn_plan(15, 4_096, 512, 4, torch.float32) == (8, 512)
    for args in [(33, 8, 16, 2), (0, 8, 16, 2), (4, 8, 1025, 2), (4, 8, 16, 9), (4, 0, 16, 2)]:
        with pytest.raises(ValueError):
            attn_ops.attn_plan(*args, torch.bfloat16)
    with pytest.raises(ValueError):
        attn_ops.attn_plan(4, 8, 16, 2, torch.float16)


@pytest.mark.parametrize("k", [4, 33], ids=["inside", "outside"])
def test_every_hop_takes_the_attention_op(monkeypatch, k):
    """Each layer calls ``dot_attention`` once, whatever its hop's size: no
    second path.  On the CPU the op's plain versions take a hop outside
    the kernels' envelope (33 slots) as well as one inside it."""
    S = 5
    gen = torch.Generator().manual_seed(6)
    blk = _block(S, k, torch.rand(S, k, generator=gen) < 0.8)
    calls = []
    op = attn_ops.dot_attention
    monkeypatch.setattr(attn_ops, "dot_attention", lambda *a: calls.append(a[1].shape) or op(*a))
    m = GraphTransformer(E, D, C, 1, num_heads=H, device="cpu")
    out = m((blk,), torch.randn(S * (k + 1), E, generator=gen), contiguous_first=True)
    assert calls == [(k, S, E)] and out.shape == (S, C) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("K,E_,H_", [(33, 16, 2), (4, 1025, 2), (4, 16, 9)])
def test_the_attention_op_raises_outside_the_envelope_past_the_cpu(monkeypatch, K, E_, H_):
    """Off the CPU a hop the kernels cannot take raises ``ValueError`` from
    the plan before any launch: too many slots, too wide an input, too many
    heads.  ('meta' tensors stand for the card, the device check patched
    out.)"""
    meta = dict(device="meta", dtype=torch.bfloat16)
    S, D_ = 6, 4
    monkeypatch.setattr(attn_ops, "_check", attn_ops._check_layout)
    before = attn_ops.score_fwd.launches
    with pytest.raises(ValueError, match="envelope"):
        attn_ops.dot_attention(torch.empty(S, E_, **meta), torch.empty(K, S, E_, **meta),
                               torch.empty(S, K, device="meta"), *(torch.empty(E_, H_ * D_, **meta) for _ in range(3)),
                               torch.empty(H_ * D_, device="meta"), H_, True)
    assert attn_ops.score_fwd.launches == before


@pytest.mark.parametrize("case", ["dtype", "qt_dtype", "mask_dtype", "rank", "qt_shape", "mask_shape",
                                  "contiguous"])
def test_the_wrappers_check_their_inputs(case):
    """Past the device check, a launch needs x_n [K, S, E] and qt [H, S, E]
    of one dtype (float32 or bfloat16), a float32 [S, K] mask, all
    contiguous."""
    meta = dict(device="meta")
    K, S, E_, H_ = 3, 8, 16, 2
    x_n = torch.empty(K, S, E_, dtype=torch.bfloat16, **meta)
    qt = torch.empty(H_, S, E_, dtype=torch.bfloat16, **meta)
    mask = torch.empty(S, K, **meta)
    assert attn_ops._check_layout(x_n, qt, mask) == (K, S, E_, H_)
    bad = {
        "dtype": (x_n.half(), qt.half(), mask),
        "qt_dtype": (x_n, qt.float(), mask),
        "mask_dtype": (x_n, qt, mask.bool()),
        "rank": (x_n.reshape(K * S, E_), qt, mask),
        "qt_shape": (x_n, torch.empty(H_, S, E_ + 1, dtype=torch.bfloat16, **meta), mask),
        "mask_shape": (x_n, qt, torch.empty(K, S, **meta)),
        "contiguous": (torch.empty(S, K, E_, dtype=torch.bfloat16, **meta).transpose(0, 1), qt, mask),
    }[case]
    with pytest.raises(ValueError):
        attn_ops._check_layout(*bad)


def test_the_wrappers_refuse_non_cpu_tensors_and_launch_through_the_plan(monkeypatch):
    """A 'meta' tensor is not a CUDA tensor: both wrappers refuse it without
    a launch.  Past the device check (patched out: no card) each passes its
    plan and shapes to its entry point and counts one launch."""
    meta = dict(device="meta")
    K, S, E_, H_ = 3, 20, 16, 2
    x_n = torch.empty(K, S, E_, dtype=torch.bfloat16, **meta)
    qt = torch.empty(H_, S, E_, dtype=torch.bfloat16, **meta)
    mask, ds = torch.empty(S, K, **meta), torch.empty(K, S, H_, **meta)
    before = (attn_ops.score_fwd.launches, attn_ops.score_bwd.launches)
    with pytest.raises(ValueError):
        attn_ops.score_fwd(x_n, qt, mask, 0.5)
    with pytest.raises(ValueError):
        attn_ops.score_bwd(x_n, qt, mask, ds, None, 0.5)
    assert (attn_ops.score_fwd.launches, attn_ops.score_bwd.launches) == before
    calls = {}

    class Lib:
        def dg_attn_score_fwd(self, *args):
            calls["fwd"] = args
            return 0

        def dg_attn_score_bwd(self, *args):
            calls["bwd"] = args
            return 0

    monkeypatch.setattr(attn_ops, "_check", attn_ops._check_layout)
    monkeypatch.setattr(attn_ops, "_lib", Lib)
    monkeypatch.setattr(attn_ops, "stream_of", lambda t: 7)
    s = attn_ops.score_fwd(x_n, qt, mask, 0.5)
    assert s.shape == (K, S, H_) and s.dtype == torch.float32
    assert calls["fwd"][4:] == (K, S, E_, H_, 0.5, 1, 8, 3, 7)
    dqt, dxn = attn_ops.score_bwd(x_n, qt, mask, ds, None, 0.5)
    assert dqt.shape == qt.shape and dxn is None and calls["bwd"][4] is None
    assert calls["bwd"][6:] == (K, S, E_, H_, 0.5, 1, 8, 3, 7)
    with pytest.raises(ValueError):
        attn_ops.score_bwd(x_n, qt, mask, ds[:, :-1], None, 0.5)
    with pytest.raises(ValueError):
        attn_ops.score_bwd(x_n, qt, mask, ds, torch.empty(K, S, E_, **meta), 0.5)
    assert attn_ops.score_fwd.launches == before[0] + 1 and attn_ops.score_bwd.launches == before[1] + 1
    attn_ops.score_fwd.launches, attn_ops.score_bwd.launches = before


@LAYOUTS
def test_tracing_leaves_outputs_bit_equal_and_records_the_spans(data, dedup_last):
    """Tracing on: every output and gradient bit-equal to tracing off; per
    layer one ``forward.attention`` and one ``forward.gate`` span with its
    ``layer``, and the counters of valid and allotted slots."""
    _, _, blocks, x, drops = _batch(data, dedup_last=dedup_last)
    runs = []
    trace.drain()
    for on in (False, True):
        m = _model()
        if on:
            trace.enable()
        try:
            y = m(blocks, x, train=True, rng=list(drops), contiguous_first=not dedup_last)
            y.square().sum().backward()
        finally:
            trace.disable()
        runs.append((y, [p.grad for p in m.parameters()]))
    spans, counters, dropped = trace.drain()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    for name in ("forward.attention", "forward.gate"):
        assert sorted(s["attrs"]["layer"] for s in spans if s["name"] == name) == [0, 1]
    assert counters["attn.slot_alloc"] == sum(b.neigh_mask.numel() for b in blocks)
    assert counters["attn.slots"] == sum(int(b.neigh_mask.sum()) for b in blocks)
    assert {s["name"] for s in spans} == {"forward.attention", "forward.gate", "forward.dropout"}
    assert dropped == 0


def test_the_model_refuses_a_wrong_block_count_and_missing_keys(data):
    _, _, blocks, x, _ = _batch(data)
    m = _model()
    with pytest.raises(ValueError):
        m(blocks[:1], x)
    with pytest.raises(ValueError, match="rng"):
        m(blocks, x, train=True)


def test_the_layout_matches_the_reference_and_no_path_starts_at_zero():
    """The model's parameters are the reference's, by name and shape; with
    the benchmark's starts (Glorot ``w`` and ``w_self``, every other leaf
    zero) the first step still moves every leaf."""
    m = GraphTransformer(E, D, C, 3, num_heads=H, device="cpu")
    cfg = {"model": dict(CFG["model"], num_layers=3), "graph": CFG["graph"]}
    shapes = ref_models.family("transformer").param_shapes(cfg)
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == shapes
    assert "layer2.ln_s" not in shapes and shapes["layer2.g"] == (3 * C,) and shapes["layer0.b"] == (3 * H * D,)
    g = _graph()
    feats = torch.randn(N, E, generator=torch.Generator().manual_seed(0))
    seeds = torch.arange(B, dtype=torch.int32) + 10
    mask = torch.ones(B, dtype=torch.bool)
    blocks, _ = sample_blocks(g, seeds, mask, (3, 2, 2), False, torch.Generator().manual_seed(1), dedup_last=False)
    blocks = tuple(reversed(blocks))
    x = feats[torch.where(blocks[0].frontier_mask, blocks[0].frontier, 0).long()]
    with torch.no_grad():
        for n, p in m.named_parameters():
            if not n.endswith((".w", ".w_self")):
                p.zero_()
    y = m(blocks, x, train=True, rng=torch.Generator().manual_seed(2), contiguous_first=True)
    F.cross_entropy(y, torch.arange(B) % C).backward()
    for n, p in m.named_parameters():
        assert p.grad.abs().max() > 0, n
