"""GAT: the port's fused op (K4/K5 plain versions), edge softmax, dropout
mask and GAT model against the JAX package on the same numpy inputs.

The JAX fused kernels run in Pallas interpret mode on the CPU, so every
call that reaches them uses S that divides their row blocks (256 rows for
E <= 128; the backward half that).  Everything is f32.  Tolerances: 1e-5
for values (the two sides differ only in summation order), 2e-4 for
gradients through the custom VJP (as tests/test_gat_kernel.py), 1e-4 for
K5's outputs one by one.  The CUDA kernels run only on the card, where
chip_smoke.py holds them to these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models.gat import GAT as JGAT
from dist_gnn_tpu.ops import gat_pallas as jgp
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.ops import spmm as jspmm
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.models import GAT as TGAT
from dist_gnn_tpu_torch.ops import gat as tgat
from dist_gnn_tpu_torch.ops import prng as tprng
from dist_gnn_tpu_torch.ops import spmm as tspmm
from dist_gnn_tpu_torch.weights import gat_params_from_jax

torch.set_num_threads(1)
SLOPE = 0.2


def _inputs(seed, S, K, E, H, D):
    """x_dst, x_n, mask_f, wal, war, w as numpy f32; row 0 fully masked,
    row 1 fully valid."""
    rng = np.random.default_rng(seed)
    mask = rng.random((S, K)) < 0.85
    mask[0, :] = False
    mask[1, :] = True
    return (
        rng.standard_normal((S, E)).astype(np.float32),
        rng.standard_normal((K, S, E)).astype(np.float32),
        mask.astype(np.float32),
        (rng.standard_normal((E, H)) * 0.1).astype(np.float32),
        (rng.standard_normal((E, H)) * 0.1).astype(np.float32),
        (rng.standard_normal((E, H * D)) * 0.1).astype(np.float32),
    )


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _scores(x_dst, x_n, wal, war):
    K, S, E = x_n.shape
    el = x_dst @ wal
    er3 = (x_n.reshape(K * S, E) @ war).reshape(K, S, -1)
    return el, er3


@pytest.mark.parametrize("K,E,H,D", [(3, 32, 2, 7), (5, 64, 4, 16)])
def test_gat_attention_forward_matches_jax(K, E, H, D):
    args = _inputs(K, 256, K, E, H, D)
    ref = jgp.gat_attention(*map(jnp.asarray, args), SLOPE, True)
    out = tgat.gat_attention(*_t(args), SLOPE, True)
    assert out.shape == (256, H * D) and out.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_give_zero():
    x_dst, x_n, mask, wal, war, w = _t(_inputs(1, 40, 4, 12, 2, 5))
    mask[:7] = 0
    out = tgat.gat_attention(x_dst, x_n, mask, wal, war, w, SLOPE, True)
    assert torch.all(out[:7] == 0) and torch.any(out[7:] != 0)


def test_gat_attention_grads_match_jax_custom_vjp():
    args = _inputs(2, 256, 4, 48, 2, 9)
    mask = jnp.asarray(args[2])

    def loss_j(xd, xn, wal, war, w):
        return jnp.sum(jnp.sin(jgp.gat_attention(xd, xn, mask, wal, war, w, SLOPE, True)))

    idx = (0, 1, 3, 4, 5)
    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(args[i]) for i in idx))
    ts = _t(args, grad=True)
    torch.sin(tgat.gat_attention(*ts, SLOPE, True)).sum().backward()
    assert ts[2].grad is None  # the mask gets no gradient
    for a, i, name in zip(gj, idx, ["dx_dst", "dx_n", "dwal", "dwar", "dw"]):
        np.testing.assert_allclose(np.asarray(a), ts[i].grad.numpy(), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("need_dx", [True, False])
def test_gat_bwd_plain_matches_pallas_bwd(need_dx):
    x_dst, x_n, mask, wal, war, w = _inputs(3, 256, 5, 32, 2, 11)
    el, er3 = _scores(x_dst, x_n, wal, war)
    g = np.random.default_rng(4).standard_normal((256, 22)).astype(np.float32)
    ref = jgp._bwd_call(*map(jnp.asarray, (x_n, el, er3, mask, w, g)), SLOPE, need_dx)
    out = tgat.gat_bwd_plain(*_t((x_n, el, er3, mask, w, g)), SLOPE, need_dx)
    names = ["dw", "d_el", "d_er3", "dxn"]
    for name, r, o in zip(names[:3], ref, out):
        np.testing.assert_allclose(np.asarray(r), o.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    if need_dx:
        np.testing.assert_allclose(np.asarray(ref[3]), out[3].numpy(), rtol=1e-4, atol=1e-4)
    else:
        assert out[3] is None
    # the wrapper on CPU tensors is the plain version and launches nothing
    wrapped = tgat.gat_bwd(*_t((x_n, el, er3, mask, w, g)), SLOPE, need_dx)
    assert all(torch.equal(a, b) for a, b in zip(wrapped[:3], out[:3]))
    assert tgat.gat_bwd.launches == tgat.gat_fwd.launches == 0


def test_need_dx_false_leaves_input_grads_zero():
    def grads(need_dx):
        ts = _t(_inputs(5, 32, 3, 16, 2, 4), grad=True)
        (tgat.gat_attention(*ts, SLOPE, need_dx) ** 2).sum().backward()
        return ts

    with_dx, without = grads(True), grads(False)
    for i in (0, 1):
        assert without[i].grad is None or torch.all(without[i].grad == 0)
        assert with_dx[i].grad.abs().max() > 0
    for i in (3, 4, 5):  # war's gradient runs through d_er3 only, so it stays
        np.testing.assert_allclose(without[i].grad.numpy(), with_dx[i].grad.numpy(), rtol=1e-6, atol=1e-7)


def test_gat_wrappers_refuse_non_cpu_tensors():
    """A tensor off the CPU reaches the kernel or raises: a 'meta' tensor
    is not a CUDA tensor, so both wrappers refuse it."""
    K, S, E, H, D = 3, 8, 4, 2, 3
    meta = dict(device="meta")
    x_n = torch.empty(K, S, E, **meta)
    el, er3, m = torch.empty(S, H, **meta), torch.empty(K, S, H, **meta), torch.empty(S, K, **meta)
    w = torch.empty(E, H * D, **meta)
    with pytest.raises(ValueError):
        tgat.gat_fwd(x_n, el, er3, m, w, SLOPE)
    with pytest.raises(ValueError):
        tgat.gat_bwd(x_n, el, er3, m, w, torch.empty(S, H * D, **meta), SLOPE, True)
    assert tgat.gat_fwd.launches == tgat.gat_bwd.launches == 0


def test_dropout_keep_bit_identical_to_jax():
    key = jax.random.key(7)
    for S, H, keep in [(33, 17, 0.5), (5, 256, 0.9)]:
        ref = np.asarray(jprng.dropout_keep(key, (S, H), keep))
        row = torch.from_numpy(np.asarray(jprng.random_keys(key, (S,))).astype(np.int64))
        out = tprng.dropout_keep(row, (S, H), keep)
        np.testing.assert_array_equal(ref, out.numpy())
    assert 0.4 < out.float().mean() < 1.0
    with pytest.raises(ValueError):
        tprng.dropout_keep(row[:3], (S, H), 0.5)


@pytest.mark.parametrize("shape", [(9, 6), (9, 6, 3)])
def test_masked_segment_softmax_matches_jax(shape):
    rng = np.random.default_rng(8)
    scores = (rng.standard_normal(shape) * 3).astype(np.float32)
    mask = rng.random(shape[:2]) < 0.6
    mask[0] = False
    ref = jspmm.masked_segment_softmax(jnp.asarray(scores), jnp.asarray(mask))
    out = tspmm.masked_segment_softmax(torch.from_numpy(scores), torch.from_numpy(mask))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(out[0] == 0)


# ---- the GAT model --------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=600, avg_degree=5, feature_dim=12, num_classes=6, train_frac=0.5, seed=3
    )
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    thg = tgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    return arrays, meta, jhg, thg


def _gat_pair(num_layers, hidden, heads, classes, use_fused_jax, use_fused_port=True, seed=0):
    jm = JGAT(12, hidden, classes, num_layers, num_heads=heads, use_fused=use_fused_jax)
    jp = jm.init(jax.random.key(seed))
    tm = TGAT(12, hidden, classes, num_layers, num_heads=heads, use_fused=use_fused_port, device="cpu")
    tm.load_state_dict(gat_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _blocks(arrays, jhg, thg, B, fan_out, dedup_last, key_seed):
    seeds = arrays["train_idx"][:B].copy()
    mask = np.ones(B, bool)
    key = jax.random.key(key_seed)
    jblocks, _ = jsampler.sample_blocks(
        jhg.to_device(), jnp.asarray(seeds), jnp.asarray(mask), fan_out, False, key,
        dedup_last=dedup_last,
    )
    keys = jax.random.split(key, len(fan_out))
    hop_keys = [
        torch.from_numpy(np.asarray(jprng.random_keys(keys[i], (b.num_dst,))).astype(np.int64))
        for i, b in enumerate(jblocks)
    ]
    tblocks, _ = tsampler.sample_blocks(
        thg.to_device("cpu"), torch.from_numpy(seeds), torch.from_numpy(mask), fan_out, False,
        hop_keys, dedup_last=dedup_last,
    )
    safe = np.where(np.asarray(jblocks[-1].frontier_mask), np.asarray(jblocks[-1].frontier), 0)
    return jblocks, tblocks, arrays["features"][safe]


def test_gat_params_from_jax_round_trip():
    jm, jp, tm = _gat_pair(3, 8, 2, 6, False)
    sd = gat_params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(tm.state_dict()) == {
        f"layer{l}.{n}" for l in range(3) for n in ("w", "a_l", "a_r", "b")
    }
    for name, v in tm.state_dict().items():
        layer, leaf = name.split(".")
        np.testing.assert_array_equal(np.asarray(jp[layer][leaf]), v.numpy())
        assert v.dtype == torch.float32 and v.shape == jp[layer][leaf].shape


def test_fused_ok_passes_the_bench_layers():
    # (S, k, d_in) per layer at the GAT bench config, frontier_caps=None
    for S, k, d_in in [(33792, 15, 100), (3072, 10, 512), (512, 5, 512)]:
        assert TGAT.fused_ok(S, k, d_in, 4), (S, k, d_in)
    assert not TGAT.fused_ok(512, 33, 512, 4)
    assert not TGAT.fused_ok(512, 5, 2048, 4)
    assert not TGAT.fused_ok(512, 5, 512, 9)


@pytest.mark.parametrize("use_fused_port", [False, True, (0,)])
@pytest.mark.parametrize("dedup_last", [True, False])
def test_gat_forward_matches_jax_plain_path(data, dedup_last, use_fused_port):
    """Arbitrary small shapes: JAX on its masked-softmax path; the port on
    the same path, on the fused op (its plain versions here), or mixed."""
    arrays, meta, jhg, thg = data
    jblocks, tblocks, x = _blocks(arrays, jhg, thg, 20, (4, 3), dedup_last, 11)
    jm, jp, tm = _gat_pair(2, 8, 2, meta["num_classes"], False, use_fused_port)
    ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(x), contiguous_first=not dedup_last)
    out = tm(tuple(reversed(tblocks)), torch.from_numpy(x), contiguous_first=not dedup_last)
    assert out.shape == (20, meta["num_classes"])
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_gat_forward_matches_jax_fused_path(data):
    """Both sides fused: batch 256, fanout (3, 2) gives layer rows 768 and
    256, which JAX's Pallas blocks divide (in 12, hidden 8 x 2 heads)."""
    arrays, meta, jhg, thg = data
    jblocks, tblocks, x = _blocks(arrays, jhg, thg, 256, (3, 2), True, 12)
    jm, jp, tm = _gat_pair(2, 8, 2, meta["num_classes"], True)
    assert [b.neigh_mask.shape[0] for b in reversed(jblocks)] == [768, 256]
    assert all(jm.fused_ok(*b.neigh_mask.shape, d) for b, d in zip(reversed(jblocks), (12, 16)))
    ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(x))
    out = tm(tuple(reversed(tblocks)), torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_gat_train_forward_dropout_matches_jax(data):
    """Train mode: the JAX rng chain split per dropout layer, injected."""
    arrays, meta, jhg, thg = data
    jblocks, tblocks, x = _blocks(arrays, jhg, thg, 20, (4, 3, 2), False, 13)
    jm, jp, tm = _gat_pair(3, 8, 2, meta["num_classes"], False)
    rng = jax.random.key(21)
    ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(x), train=True, rng=rng,
                   contiguous_first=True)
    keys, r = [], rng
    for b in list(reversed(jblocks))[:-1]:
        r, sub = jax.random.split(r)
        keys.append(torch.from_numpy(np.asarray(jprng.random_keys(sub, (b.num_dst,))).astype(np.int64)))
    out = tm(tuple(reversed(tblocks)), torch.from_numpy(x), train=True, rng=keys, contiguous_first=True)
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rng"):
        tm(tuple(reversed(tblocks)), torch.from_numpy(x), train=True, contiguous_first=True)


@pytest.mark.parametrize("input_grad", [False, True])
def test_gat_input_grad_reaches_the_first_layer_input(data, input_grad):
    """The fused first layer computes d_x only when asked (need_dx)."""
    arrays, meta, jhg, thg = data
    _, tblocks, x = _blocks(arrays, jhg, thg, 20, (4, 3), False, 14)
    tm = TGAT(12, 8, meta["num_classes"], 2, num_heads=2, input_grad=input_grad, device="cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    tm(tuple(reversed(tblocks)), tx, contiguous_first=True).sum().backward()
    if input_grad:
        assert tx.grad is not None and tx.grad.abs().max() > 0
    else:
        assert tx.grad is None
    assert all(p.grad is not None for p in tm.parameters())


def test_gat_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGAT(12, 8, 6, 2)
