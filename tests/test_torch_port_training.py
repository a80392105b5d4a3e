"""Training: the K3 gradient, Adam with coupled L2, and ``Trainer.train_step``
against the JAX package from the same params on the same injected keys.

Keys: JAX's step derives ``k_sample, k_drop = split(fold_in(key, step))``,
splits k_sample once per hop and k_drop once per dropout layer.  The tests
rebuild that chain in JAX and hand the port the per-hop sampler keys and
per-layer dropout row keys.  Everything is f32.  Tolerances: step-1 loss
1e-5 and gradients rtol 1e-4 / atol 1e-6 (summation order only); the three
losses 1e-4; params after 3 Adam steps atol 5e-3, because Adam's first
steps move each element by about lr * sign(g), and the sign of a gradient
element near 0 can differ between the two frameworks
(tests/test_gat_kernel.py:133-136 accepts the same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models.gat import GAT as JGAT
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.ops import spmm as jspmm
from dist_gnn_tpu.training import Trainer as JTrainer
from dist_gnn_tpu.training.trainer import make_optimizer as jmake_optimizer
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch.models import GAT as TGAT
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.ops import spmm as tspmm
from dist_gnn_tpu_torch.training import Trainer as TTrainer
from dist_gnn_tpu_torch.training import make_optimizer
from dist_gnn_tpu_torch.weights import gat_params_from_jax, sage_params_from_jax

torch.set_num_threads(1)
INVALID = int(jgraph.INVALID_ID)


def _mean_inputs(cap, S, k, F, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((cap, F)).astype(np.float32)
    slots = rng.integers(0, cap, (S, k)).astype(np.int32)
    slots[3, :2] = slots[3, 2]  # duplicate slots within a row
    mask = rng.random((S, k)) < 0.7
    mask[:2] = False
    mask[3, :3] = True
    d_out = rng.standard_normal((S, F)).astype(np.float32)
    return h, slots, mask, d_out


@pytest.mark.parametrize("S,k", [(12, 5), (9, 15)])
def test_gather_mean_grad_matches_jax(S, k):
    h, slots, mask, d_out = _mean_inputs(30, S, k, 8, S + k)
    _, vjp = jax.vjp(lambda x: jspmm.gather_mean(x, jnp.asarray(slots), jnp.asarray(mask)), jnp.asarray(h))
    (ref,) = vjp(jnp.asarray(d_out))
    th = torch.from_numpy(h).requires_grad_(True)
    out = tgather.gather_mean(th, torch.from_numpy(slots), torch.from_numpy(mask))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(d_out))
    np.testing.assert_allclose(np.asarray(ref), th.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_mean_bwd_plain_matches_autograd(dtype):
    h, slots, mask, d_out = _mean_inputs(25, 11, 6, 5, 0)
    th = torch.from_numpy(h).to(torch.float64).requires_grad_(True)
    tspmm.gather_mean(th, torch.from_numpy(slots), torch.from_numpy(mask)).backward(
        torch.from_numpy(d_out).to(torch.float64)
    )
    out = tgather.gather_mean_bwd_plain(
        torch.from_numpy(d_out).to(dtype), torch.from_numpy(slots), torch.from_numpy(mask), 25
    )
    assert out.shape == (25, 5) and out.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(th.grad.numpy(), out.double().numpy(), rtol=tol, atol=tol)
    assert tgather.gather_mean_bwd.launches == tgather.gather_mean.launches == 0


def test_gather_mean_bwd_refuses_non_cpu_tensors():
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tgather.gather_mean_bwd(
            torch.empty(4, 8, **meta), torch.empty(4, 3, dtype=torch.int32, **meta),
            torch.empty(4, 3, dtype=torch.bool, **meta), 30,
        )
    assert tgather.gather_mean_bwd.launches == 0


def test_make_optimizer_is_optax_adam_with_coupled_l2():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    opt = jmake_optimizer(1e-2, 5e-2)
    jp, st = jnp.asarray(p0), None
    st = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = make_optimizer([tp], 1e-2, 5e-2)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(np.asarray(jp), tp.detach().numpy(), rtol=1e-6, atol=1e-6)


# ---- train_step ------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=400, avg_degree=5, feature_dim=12, num_classes=6, train_frac=0.3, seed=1
    )
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    thg = tgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    return arrays, meta, jhg, thg


def _models(kind, meta):
    if kind == "sage":
        jm = JSAGE(12, 16, meta["num_classes"], 3)
        tm = TSAGE(12, 16, meta["num_classes"], 3, device="cpu")
        conv = sage_params_from_jax
    else:  # JAX on its masked-softmax path, the port on the fused op
        jm = JGAT(12, 8, meta["num_classes"], 3, num_heads=2, use_fused=False)
        tm = TGAT(12, 8, meta["num_classes"], 3, num_heads=2, device="cpu")
        conv = gat_params_from_jax
    jp = jm.init(jax.random.key(0))
    tm.load_state_dict(conv(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _keys(torch_ints):
    return torch.from_numpy(np.asarray(torch_ints).astype(np.int64))


def _step_keys(key, step, jblocks, n_hops):
    """The port's (hop keys, dropout row keys) for JAX's step ``step``."""
    k_sample, k_drop = jax.random.split(jax.random.fold_in(key, step))
    hk = jax.random.split(k_sample, n_hops)
    hop = [_keys(jprng.random_keys(hk[i], (b.num_dst,))) for i, b in enumerate(jblocks)]
    drop, rng = [], k_drop
    for b in list(reversed(jblocks))[:-1]:  # every hidden layer, input-first
        rng, sub = jax.random.split(rng)
        drop.append(_keys(jprng.random_keys(sub, (b.num_dst,))))
    return k_sample, k_drop, hop, drop


@pytest.mark.parametrize("kind,dedup_last", [("sage", False), ("gat", True)])
def test_train_step_matches_jax(data, kind, dedup_last):
    arrays, meta, jhg, thg = data
    fan_out = (4, 3, 2)
    jm, jp, tm = _models(kind, meta)
    jtr = JTrainer(model=jm, fan_out=fan_out, dedup_last=dedup_last)
    ttr = TTrainer(model=tm, fan_out=fan_out, dedup_last=dedup_last, device="cpu")
    assert tm.dropout == 0.5
    jg, tg = jhg.to_device(), thg.to_device("cpu")
    feats, labels = jnp.asarray(arrays["features"]), jnp.asarray(arrays["labels"])
    tfeats, tlabels = torch.from_numpy(arrays["features"]), torch.from_numpy(arrays["labels"])
    seeds = arrays["train_idx"][:24].copy()
    seeds[-4:] = INVALID
    mask = seeds != INVALID
    js, jmask = jnp.asarray(seeds), jnp.asarray(mask)
    key = jax.random.key(5)
    state = jtr.init_state(jax.random.key(0))
    state = state._replace(params=jp, opt_state=jtr.optimizer.init(jp))
    for step in range(3):
        k_sample = jax.random.split(jax.random.fold_in(key, step))[0]
        jblocks, _ = jsampler.sample_blocks(jg, js, jmask, fan_out, False, k_sample, dedup_last=dedup_last)
        _, k_drop, hop, drop = _step_keys(key, step, jblocks, len(fan_out))
        if step == 0:
            safe = jnp.where(jblocks[-1].frontier_mask, jblocks[-1].frontier, 0)
            blab = jnp.where(jmask, labels[jnp.where(jmask, js, 0)], 0)
            (jloss, _), jgrads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
                state.params, jblocks, feats[safe], blab, jmask, k_drop
            )
        state, jmet = jtr.train_step(state, jg, feats, labels, js, jmask, key)
        tmet = ttr.train_step(tg, tfeats, tlabels, torch.from_numpy(seeds), torch.from_numpy(mask), (hop, drop))
        assert set(tmet) == {"loss", "acc", "sampler_overflow", "frontier_overflow"}
        assert all(v.dim() == 0 for v in tmet.values())
        np.testing.assert_allclose(float(jmet["loss"]), float(tmet["loss"]), rtol=1e-4, atol=1e-4)
        assert float(jmet["acc"]) == pytest.approx(float(tmet["acc"]), abs=1e-6)
        if step == 0:
            np.testing.assert_allclose(float(jloss), float(tmet["loss"]), rtol=1e-5, atol=1e-5)
            for name, p in tm.named_parameters():
                layer, leaf = name.split(".")
                np.testing.assert_allclose(
                    np.asarray(jgrads[layer][leaf]), p.grad.numpy(), rtol=1e-4, atol=1e-6, err_msg=name
                )
    for name, p in tm.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(np.asarray(state.params[layer][leaf]), p.detach().numpy(), atol=5e-3, err_msg=name)
    assert tgather.gather_rows.launches == tgather.gather_mean.launches == tgather.gather_mean_bwd.launches == 0


def test_train_step_multi_equals_single_steps(data):
    arrays, meta, _, thg = data
    tg = thg.to_device("cpu")
    feats, labels = torch.from_numpy(arrays["features"]), torch.from_numpy(arrays["labels"])
    seeds = torch.from_numpy(arrays["train_idx"][:30].astype(np.int32)).reshape(3, 10)
    masks = torch.ones(3, 10, dtype=torch.bool)
    masks[2, -3:] = False
    runs = []
    for multi in (False, True):
        tm = TSAGE(12, 16, meta["num_classes"], 3, generator=torch.Generator().manual_seed(4), device="cpu")
        tr = TTrainer(model=tm, fan_out=(3, 2, 2), dedup_last=False, device="cpu")
        gen = torch.Generator().manual_seed(9)
        if multi:
            met = tr.train_step_multi(tg, feats, labels, seeds, masks, gen)
        else:
            for u in range(3):
                met = tr.train_step(tg, feats, labels, seeds[u], masks[u], gen)
        runs.append((met, {k: v.detach().clone() for k, v in tm.state_dict().items()}))
    (m1, p1), (m2, p2) = runs
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["acc"], m2["acc"])
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert int(m2["sampler_overflow"]) == int(m2["frontier_overflow"]) == 0


def test_train_step_learns_on_a_generator(data):
    """Loss falls over a few epochs of the small graph with generated keys."""
    arrays, meta, _, thg = data
    tg = thg.to_device("cpu")
    feats, labels = torch.from_numpy(arrays["features"]), torch.from_numpy(arrays["labels"])
    tm = TGAT(12, 8, meta["num_classes"], 2, num_heads=2, generator=torch.Generator().manual_seed(0), device="cpu")
    tr = TTrainer(model=tm, fan_out=(3, 3), lr=1e-2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    seeds = torch.from_numpy(arrays["train_idx"][:64].astype(np.int32))
    mask = torch.ones(64, dtype=torch.bool)
    losses = [float(tr.train_step(tg, feats, labels, seeds, mask, gen)["loss"]) for _ in range(15)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_trainer_raises_without_a_card(monkeypatch):
    tm = TSAGE(12, 16, 6, 3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTrainer(model=tm, fan_out=(2, 2, 2), lr=1e-2)
