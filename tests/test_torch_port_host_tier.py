"""The host-resident tiers (``host_tier.py``, ``training/pipeline.py``)
against the JAX package on the same numpy inputs and injected keys, on
the CPU.

Tolerances: ``assemble_features`` exact (row copies); ``sample_staged_hop``
bit-identical ids and mask with JAX's keys and the same numpy seed for the
hub rows; ``compute_step``'s loss, gradients and updated params 1e-5
(f32, summation order only); the pipelined run equal to the sequential
one; learning as ``tests/test_host_tier.py`` asks (last loss < 0.85 x the
first).
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import host_tier as jht
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.training.pipeline import HostTierTrainer as JHostTierTrainer
from dist_gnn_tpu_torch import host_tier as tht
from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
from dist_gnn_tpu_torch.models import GAT as TGAT
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.ops import gather, sampling
from dist_gnn_tpu_torch.sampler import Block
from dist_gnn_tpu_torch.training.pipeline import HostTierTrainer, batch_keys
from dist_gnn_tpu_torch.utils import native
from dist_gnn_tpu_torch.weights import sage_params_from_jax

torch.set_num_threads(1)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(x.astype(np.int64) if x.dtype == np.uint32 else x))


def _frontier(rng, n, L, p_valid=0.9):
    f = rng.integers(0, n, L).astype(np.int32)
    m = rng.random(L) < p_valid
    return np.where(m, f, INVALID_ID).astype(np.int32), m


# ---- features: stage + assemble_features ---------------------------------


def _assemble_both(base, hot, budget, frontier, fmask):
    jstore = jht.HostFeatureStore(base, hot, miss_budget=budget)
    tstore = tht.HostFeatureStore(base, hot, miss_budget=budget, device="cpu")
    assert tstore.hit_rate(frontier[fmask]) == jstore.hit_rate(frontier[fmask])
    js = jstore.stage(frontier, fmask)
    ts = tstore.stage(frontier, fmask)
    assert (ts.count, ts.overflow) == (js.count, js.overflow)
    # the port ships exactly the miss rows; JAX pads them to a static slab
    # of zero rows at the spare slot L
    m = ts.count
    assert ts.rows.shape == (m, base.shape[1]) and ts.slots.shape == (m,)
    np.testing.assert_array_equal(ts.rows.numpy(), np.asarray(js.rows)[:m])
    np.testing.assert_array_equal(ts.slots.numpy(), np.asarray(js.slots)[:m])
    assert not np.asarray(js.rows)[m:].any() and (np.asarray(js.slots)[m:] == len(frontier)).all()
    want = jax.jit(jht.assemble_features)(
        jstore.hot_tier, jnp.asarray(frontier), jnp.asarray(fmask), js.rows, js.slots
    )
    got = tht.assemble_features(tstore.hot_tier, torch.from_numpy(frontier), torch.from_numpy(fmask),
                                ts.rows, ts.slots)
    return tstore, ts, got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "n_hot,budget,p_valid",
    [(80, 96, 0.9), (10, 5, 1.0), (0, 16, 0.8), (300, 8, 0.7), (120, 0, 0.95)],
    ids=["both_tiers", "overflow_grows", "no_hot_tier", "all_hot", "zero_budget"],
)
def test_assemble_features_matches_oracle_and_jax(n_hot, budget, p_valid):
    rng = np.random.default_rng(n_hot + budget)
    N, F = 300, 16
    base = rng.standard_normal((N, F)).astype(np.float32)
    hot = np.concatenate([rng.choice(N, n_hot, replace=False), [INVALID_ID]]).astype(np.int32)
    frontier, fmask = _frontier(rng, N, 120, p_valid)
    _, ts, got, want = _assemble_both(base, hot, budget, frontier, fmask)
    oracle = np.where(fmask[:, None], base[np.where(fmask, frontier, 0)], 0)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, want)
    misses = int((fmask & ~np.isin(frontier, hot)).sum())
    assert ts.count == misses and ts.overflow == max(0, misses - budget)
    assert ts.rows.shape[0] == ts.count and ts.copy is None and ts.h2d_ms() is None
    assert gather.gather_rows.launches == 0


def test_assemble_features_from_a_memmap_base_with_a_bf16_hot_tier(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((200, 8)).astype(np.float32)
    mm = np.memmap(tmp_path / "feats.bin", dtype=np.float32, mode="w+", shape=arr.shape)
    mm[:] = arr
    hot = rng.choice(200, 70, replace=False)
    frontier, fmask = _frontier(rng, 200, 90)
    _, _, got, want = _assemble_both(mm, hot, 32, frontier, fmask)
    np.testing.assert_array_equal(got, np.where(fmask[:, None], arr[np.where(fmask, frontier, 0)], 0))
    np.testing.assert_array_equal(got, want)
    store = tht.HostFeatureStore(mm, hot, 32, hot_dtype=torch.bfloat16, device="cpu")
    st = store.stage(frontier, fmask)
    out = tht.assemble_features(store.hot_tier, torch.from_numpy(frontier), torch.from_numpy(fmask),
                                st.rows, st.slots)
    assert out.dtype == torch.bfloat16
    oracle = torch.from_numpy(np.where(fmask[:, None], arr[np.where(fmask, frontier, 0)], 0)).to(torch.bfloat16)
    assert torch.equal(out, oracle)


def test_stage_goes_through_the_native_gather():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((100, 4)).astype(np.float32)
    store = tht.HostFeatureStore(base, np.arange(10), 8, device="cpu")
    calls = native.gather_rows.calls
    st = store.stage(np.arange(20, 60, dtype=np.int32), np.ones(40, bool))
    assert native.gather_rows.calls == calls + 1 and st.count == 40 and st.gather_s >= 0


def test_host_feature_store_refuses_integer_hot_dtype_and_bad_ids():
    base = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError):
        tht.HostFeatureStore(base, np.arange(5), 4, hot_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError):
        tht.HostFeatureStore(base, np.array([3, 10]), 4, device="cpu")


# ---- structure: plan_hop + sample_staged_hop -----------------------------


def _hub_graph(seed, n=400, e=5000):
    """Power-law in-degrees: many rows above a small deg_cap."""
    rng = np.random.default_rng(seed)
    dst = (rng.pareto(1.2, e) * 5).astype(np.int64) % n
    thg = HostGraph.from_coo(rng.integers(0, n, e), dst, n)
    return thg, jgraph.HostGraph(indptr=thg.indptr, indices=thg.indices), rng


@pytest.mark.parametrize(
    "L,k,n_hot,miss_budget,deg_cap",
    [(64, 5, 150, 64, 8), (200, 10, 40, 200, 16), (300, 15, 100, 50, 32), (50, 4, 0, 50, 2)],
    ids=["hubs", "wide", "overflow", "no_hot_tier"],
)
def test_sample_staged_hop_is_bit_identical_to_jax(L, k, n_hot, miss_budget, deg_cap):
    thg, jhg, rng = _hub_graph(L + k)
    hot = rng.choice(thg.num_nodes, n_hot, replace=False).astype(np.int32)
    seeds, mask = _frontier(rng, thg.num_nodes, L)
    jg = jht.HostCSCStore(jhg, hot, miss_budget=miss_budget, deg_cap=deg_cap)
    tg = tht.HostCSCStore(thg, hot, miss_budget=miss_budget, deg_cap=deg_cap, device="cpu")
    assert tg.hit_rate(seeds[mask]) == jg.hit_rate(seeds[mask])
    j_local, jst = jg.plan_hop(seeds, mask, k, np.random.default_rng(9))
    t_local, tst = tg.plan_hop(seeds, mask, k, np.random.default_rng(9))
    np.testing.assert_array_equal(t_local, np.asarray(j_local))
    assert (tst.count, tst.overflow) == (jst.count, jst.overflow)
    assert int(np.asarray(jst.is_pre).sum()) == int(tst.is_pre.sum())
    key = jax.random.key(L * k)
    want = jax.jit(jht.sample_staged_hop, static_argnames=("k",))(
        jg.hot_graph, jnp.asarray(j_local), jst, k=k, key=key
    )
    hot_keys = _t(jprng.random_keys(key, (L,)))
    staged_keys = _t(jprng.random_keys(jax.random.fold_in(key, 1), (miss_budget,)))[: tst.count]
    got = tht.sample_staged_hop(tg.hot_graph, torch.from_numpy(t_local), tst, k, (hot_keys, staged_keys))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.any() and (got.ids.numpy()[~got.mask.numpy()] == INVALID_ID).all()
    if deg_cap < 16:
        assert bool(tst.is_pre.any())  # hub rows presampled on the host
    assert sampling.sample_uniform.launches == 0


def test_plan_hop_ships_a_compact_sub_csc():
    thg, _, rng = _hub_graph(1)
    tg = tht.HostCSCStore(thg, np.arange(50), miss_budget=500, deg_cap=8, device="cpu")
    seeds, mask = _frontier(rng, thg.num_nodes, 120)
    _, st = tg.plan_hop(seeds, mask, 4, np.random.default_rng(0))
    deg = np.diff(thg.indptr.astype(np.int64))
    ids = seeds[st.row_of.numpy()]
    want_deg = np.where(deg[ids] <= 8, deg[ids], 0)
    np.testing.assert_array_equal(np.diff(st.graph.indptr.numpy()), want_deg)
    assert st.graph.num_edges == int(want_deg.sum()) < st.count * 8 + 1
    np.testing.assert_array_equal(st.is_pre.numpy(), deg[ids] > 8)


def test_weighted_structure_raises():
    """A weighted ``HostCSCStore`` builds (its hot sub-CSC carries the
    weights and their alias tables); weights that are not parallel to the
    edges raise."""
    rng = np.random.default_rng(2)
    hg = HostGraph.from_coo(rng.integers(0, 50, 200), rng.integers(0, 50, 200), 50,
                            probs=rng.random(200).astype(np.float32))
    store = tht.HostCSCStore(hg, np.arange(10), miss_budget=16, device="cpu")
    hot = store.hot_graph
    assert hot.probs is not None and hot.alias_prob is not None and hot.alias_idx is not None
    sp, _, spr = native.extract_subcsc(np.arange(10), hg.indptr, hg.indices, hg.probs)
    np.testing.assert_array_equal(hot.probs.numpy(), spr)
    np.testing.assert_array_equal(hot.alias_prob.numpy(), native.build_alias(sp, spr)[0])
    with pytest.raises(ValueError):
        HostGraph(indptr=hg.indptr, indices=hg.indices, probs=hg.probs[:-1])


def _weighted_hub_graph(seed, n=400, e=5000):
    """``_hub_graph`` with |N(0, 1)| weights, a fifth of them 0."""
    rng = np.random.default_rng(seed)
    dst = (rng.pareto(1.2, e) * 5).astype(np.int64) % n
    w = np.abs(rng.standard_normal(e)).astype(np.float32)
    w[rng.random(e) < 0.2] = 0
    thg = HostGraph.from_coo(rng.integers(0, n, e), dst, n, probs=w)
    return thg, jgraph.HostGraph(indptr=thg.indptr, indices=thg.indices, probs=thg.probs), rng


@pytest.mark.parametrize(
    "L,k,n_hot,miss_budget,deg_cap",
    [(64, 5, 150, 64, 8), (200, 10, 40, 200, 16), (300, 15, 100, 50, 32), (50, 4, 0, 50, 6)],
    ids=["hubs", "wide", "overflow", "no_hot_tier"],
)
def test_weighted_sample_staged_hop_is_bit_identical_to_jax(L, k, n_hot, miss_budget, deg_cap):
    """Hot rows through the alias sampler (K8's plain version; JAX's
    ``sample_biased_alias``), staged rows through the Gumbel top-k of the
    whole row (K7's; JAX's staged window), hub rows presampled on the host
    with JAX's explicit Gumbel keys from the same numpy seed: ids and mask
    equal JAX's on its keys.  (JAX needs deg_cap >= k for its top-k.)"""
    thg, jhg, rng = _weighted_hub_graph(L + k)
    hot = rng.choice(thg.num_nodes, n_hot, replace=False).astype(np.int32)
    seeds, mask = _frontier(rng, thg.num_nodes, L)
    jg = jht.HostCSCStore(jhg, hot, miss_budget=miss_budget, deg_cap=deg_cap)
    tg = tht.HostCSCStore(thg, hot, miss_budget=miss_budget, deg_cap=deg_cap, device="cpu")
    j_local, jst = jg.plan_hop(seeds, mask, k, np.random.default_rng(9))
    t_local, tst = tg.plan_hop(seeds, mask, k, np.random.default_rng(9))
    np.testing.assert_array_equal(t_local, np.asarray(j_local))
    assert (tst.count, tst.overflow) == (jst.count, jst.overflow)
    np.testing.assert_array_equal(tst.pre_ids.numpy(), np.asarray(jst.pre_ids)[: tst.count])
    key = jax.random.key(L * k)
    want = jax.jit(jht.sample_staged_hop, static_argnames=("k",))(
        jg.hot_graph, jnp.asarray(j_local), jst, k=k, key=key
    )
    if n_hot:  # the hot sub-CSC has alias tables: the alias sampler's keys
        hot_keys = (_t(jprng.random_keys(key, (2, L, 4 * k))),
                    _t(jprng.random_keys(jax.random.fold_in(key, 1), (L, 2 * k))))
    else:  # an empty hot tier: JAX's dispatch takes sample_biased
        hot_keys = _t(jprng.random_keys(key, (L,)))
    staged_keys = _t(jprng.random_keys(jax.random.fold_in(key, 1), (miss_budget,)))[: tst.count]
    got = tht.sample_staged_hop(tg.hot_graph, torch.from_numpy(t_local), tst, k, (hot_keys, staged_keys))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.any() and (got.ids.numpy()[~got.mask.numpy()] == INVALID_ID).all()
    assert tst.graph.probs is not None and bool(tst.is_pre.any())
    assert sampling.sample_biased.launches == sampling.sample_biased_alias.launches == 0


def test_biased_staged_hop_matches_ares_oracle():
    """The port's analogue of ``tests/test_host_tier.py:125``: a weighted
    row of 6 edges sampled staged (K7's rule), hot (the alias sampler) and,
    as a hub row above deg_cap, presampled on the host; each tier includes
    the edges as A-Res does (0.04, JAX's limit), and the hub's heavier
    edges out-appear its lighter ones."""
    rng = np.random.default_rng(5)
    N = 200
    w_hub = np.array([1.0, 1.0, 2.0, 2.0, 4.0, 4.0], np.float32)
    src, dst, w = [j + 1 for j in range(6)], [0] * 6, list(w_hub)
    for j in range(40):  # a weighted row of 40 at node 1 (> deg_cap)
        src.append(10 + j), dst.append(1), w.append(1.0 + (j % 4))
    for v in range(2, N):
        src.append((v + 1) % N), dst.append(v), w.append(1.0)
    hg = HostGraph.from_coo(np.asarray(src), np.asarray(dst), N, probs=np.asarray(w, np.float32))
    k = 3
    orng = np.random.default_rng(99)
    oracle = np.zeros(6)
    for _ in range(60_000):
        oracle[np.argsort(-(np.log(orng.random(6)) / w_hub))[:k]] += 1
    oracle /= 60_000
    gen = torch.Generator().manual_seed(0)

    def inclusion(store, trials=6, L=128):
        counts = np.zeros(7)
        for _ in range(trials):
            local_rows, staged = store.plan_hop(np.zeros(L, np.int32), np.ones(L, bool), k, rng)
            assert staged.overflow == 0
            nb = tht.sample_staged_hop(store.hot_graph, torch.from_numpy(local_rows), staged, k, gen)
            ids, msk = nb.ids.numpy(), nb.mask.numpy()
            assert msk.all()
            counts += np.bincount(ids[msk], minlength=7)
        return counts[1:] / (trials * L)

    cold = tht.HostCSCStore(hg, np.arange(50, 80, dtype=np.int32), miss_budget=256, deg_cap=16, device="cpu")
    np.testing.assert_allclose(inclusion(cold), oracle, atol=0.04)
    hot = tht.HostCSCStore(hg, np.asarray([0], np.int32), miss_budget=256, deg_cap=16, device="cpu")
    np.testing.assert_allclose(inclusion(hot), oracle, atol=0.04)
    pre_counts = np.zeros(N)
    for _ in range(40):
        local_rows, staged = cold.plan_hop(np.ones(16, np.int32), np.ones(16, bool), k, rng)
        assert staged.is_pre.all()
        nb = tht.sample_staged_hop(cold.hot_graph, torch.from_numpy(local_rows), staged, k, gen)
        ids, msk = nb.ids.numpy(), nb.mask.numpy()
        assert msk.all() and set(ids[msk].tolist()) <= set(range(10, 50))
        pre_counts += np.bincount(ids[msk], minlength=N)
    heavy = sum(pre_counts[10 + j] for j in range(40) if j % 4 == 3)
    light = sum(pre_counts[10 + j] for j in range(40) if j % 4 == 0)
    assert heavy > 1.5 * light, (heavy, light)


# ---- training/pipeline ---------------------------------------------------


def _problem(seed):
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=800, avg_degree=6, feature_dim=12, num_classes=4, train_frac=0.5, seed=seed,
    )
    return arrays, meta, HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])


def test_replace_with_host_structure_raises():
    arrays, meta, hg = _problem(0)
    fstore = tht.HostFeatureStore(arrays["features"], np.arange(10), 64, device="cpu")
    gstore = tht.HostCSCStore(hg, np.arange(10), 64, device="cpu")
    model = TSAGE(12, 8, 4, 2, device="cpu")
    with pytest.raises(NotImplementedError):
        HostTierTrainer(model=model, fan_out=(3, 3), store=fstore, gstore=gstore, replace=True, device="cpu")
    HostTierTrainer(model=model, fan_out=(3, 3), store=fstore, replace=True, device="cpu")


@pytest.mark.parametrize("dedup_last", [True, False])
def test_compute_step_matches_jax(dedup_last):
    arrays, meta, hg = _problem(5)
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    feats = arrays["features"]
    labels = np.asarray(arrays["labels"], np.int32)
    hot = np.random.default_rng(0).choice(800, 200, replace=False)
    fan_out = (3, 3)
    jm = JSAGE(12, 16, 4, 2, dropout=0.0)
    jtr = JHostTierTrainer(model=jm, fan_out=fan_out, store=jht.HostFeatureStore(feats, hot, 512),
                           dedup_last=dedup_last)
    jp = jm.init(jax.random.key(0))
    state = jtr.init_state(jax.random.key(0))
    state = state._replace(params=jp, opt_state=jtr.optimizer.init(jp))
    tm = TSAGE(12, 16, 4, 2, dropout=0.0, device="cpu")
    tm.load_state_dict(sage_params_from_jax(jax.tree.map(np.asarray, jp)))
    ttr = HostTierTrainer(model=tm, fan_out=fan_out, store=tht.HostFeatureStore(feats, hot, 512, device="cpu"),
                          dedup_last=dedup_last, device="cpu")
    seeds = arrays["train_idx"][:40].astype(np.int32)
    seeds[-5:] = INVALID_ID
    mask = seeds != INVALID_ID
    jblocks, _ = jsampler.sample_blocks(jhg.to_device(), jnp.asarray(seeds), jnp.asarray(mask), fan_out, False,
                                        jax.random.key(3), dedup_last=dedup_last)
    tblocks = tuple(Block(**{f: torch.from_numpy(np.array(getattr(b, f))) for f in Block._fields})
                    for b in jblocks)
    frontier, fmask = np.asarray(jblocks[-1].frontier), np.asarray(jblocks[-1].frontier_mask)
    jst = jtr.store.stage(frontier, fmask)
    lab = labels[np.where(mask, seeds, 0)]
    feats_j = jht.assemble_features(jtr.store.hot_tier, jnp.asarray(frontier), jnp.asarray(fmask), jst.rows, jst.slots)
    (jloss, _), jgrads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
        state.params, jblocks, feats_j, jnp.asarray(lab), jnp.asarray(mask), jax.random.key(1)
    )
    state, jmet = jtr.compute_step(state, jtr.store.hot_tier, jblocks, jst.rows, jst.slots,
                                   jnp.asarray(lab), jnp.asarray(mask), jax.random.key(1))
    tst = ttr.store.stage(frontier, fmask)
    assert tst.count > 0
    tmet = ttr.compute_step(tblocks, tst, ttr.batch_labels(labels, seeds, mask), torch.from_numpy(mask),
                            torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tmet["loss"]), float(jloss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5, atol=1e-6)
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-6)
    for name, p in tm.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[layer][leaf]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(state.params[layer][leaf]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _batches(arrays, n, size, seed0):
    train = arrays["train_idx"]
    return [(train[np.random.default_rng(seed0 + s).choice(len(train), size, replace=False)],
             np.ones(size, bool)) for s in range(n)]


@pytest.mark.parametrize("kind", ["sage", "gat"])
@pytest.mark.parametrize("host_struct", [False, True])
def test_pipelined_run_equals_sequential_run(host_struct, kind):
    arrays, meta, hg = _problem(5)
    labels = np.asarray(arrays["labels"], np.int32)
    batches = _batches(arrays, 6, 32, 0)
    params = []
    for pipelined in (True, False):
        fstore = tht.HostFeatureStore(arrays["features"], np.arange(50), 2048, device="cpu")
        gstore = tht.HostCSCStore(hg, np.arange(0, 800, 3), 2048, deg_cap=8, device="cpu") if host_struct else None
        gen = torch.Generator().manual_seed(0)  # dropout 0.5 in both models
        model = (TSAGE(12, 8, 4, 2, generator=gen, device="cpu") if kind == "sage"
                 else TGAT(12, 4, 4, 2, num_heads=2, generator=gen, device="cpu"))
        tr = HostTierTrainer(model=model, fan_out=(3, 3), store=fstore, gstore=gstore, device="cpu")
        graph = None if host_struct else hg.to_device("cpu")
        if pipelined:
            metrics = tr.train_batches(graph, labels, batches, 11)
            assert len(metrics) == 6 and all(m["feat_miss"] > 0 for m in metrics)
            if host_struct:
                assert any(m["struct_miss"] > 0 for m in metrics)
        else:
            rng = np.random.default_rng(11)
            for i, (s, mk) in enumerate(batches):
                sk, dk = batch_keys(11, i, tr.device)
                blocks, _, f, fm = tr.sample(graph, s, mk, sk, rng)
                tr.compute_step(blocks, fstore.stage(f, fm), tr.batch_labels(labels, s, mk),
                                torch.from_numpy(mk), dk)
        params.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])


@pytest.mark.parametrize("host_struct", [False, True])
def test_weighted_pipelined_run_equals_sequential_run(host_struct):
    """``HostTierTrainer`` on a weighted graph: with the structure on the
    device (alias tables: K8 per hop) or host-resident (K8 hot, K7 staged,
    Gumbel-presampled hubs), the pipelined run equals a sequential one, and
    the model learns nothing non-finite."""
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=800, avg_degree=6, feature_dim=12, num_classes=4, train_frac=0.5, with_probs=True, seed=5,
    )
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"], probs=arrays["probs"])
    labels = np.asarray(arrays["labels"], np.int32)
    batches = _batches(arrays, 5, 32, 0)
    params = []
    for pipelined in (True, False):
        fstore = tht.HostFeatureStore(arrays["features"], np.arange(50), 2048, device="cpu")
        gstore = tht.HostCSCStore(hg, np.arange(0, 800, 3), 2048, deg_cap=8, device="cpu") if host_struct else None
        model = TSAGE(12, 8, 4, 2, generator=torch.Generator().manual_seed(0), device="cpu")
        tr = HostTierTrainer(model=model, fan_out=(3, 3), store=fstore, gstore=gstore, device="cpu")
        graph = None if host_struct else hg.to_device("cpu", with_alias=True)
        if pipelined:
            metrics = tr.train_batches(graph, labels, batches, 11)
            assert all(np.isfinite(float(m["loss"])) for m in metrics)
            if host_struct:
                assert any(m["struct_miss"] > 0 for m in metrics)
        else:
            rng = np.random.default_rng(11)
            for i, (s, mk) in enumerate(batches):
                sk, dk = batch_keys(11, i, tr.device)
                blocks, _, f, fm = tr.sample(graph, s, mk, sk, rng)
                tr.compute_step(blocks, fstore.stage(f, fm), tr.batch_labels(labels, s, mk),
                                torch.from_numpy(mk), dk)
        params.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])


@pytest.mark.parametrize("host_struct", [False, True])
def test_train_batches_releases_each_batch_s_staged_rows(host_struct):
    """A batch's staged rows are freed once its compute step is queued:
    device memory must not grow with the number of batches of a call."""
    arrays, meta, hg = _problem(5)
    fstore = tht.HostFeatureStore(arrays["features"], np.arange(50), 2048, device="cpu")
    gstore = tht.HostCSCStore(hg, np.arange(0, 800, 3), 2048, deg_cap=8, device="cpu") if host_struct else None
    tr = HostTierTrainer(model=TSAGE(12, 8, 4, 2, device="cpu"), fan_out=(3, 3), store=fstore,
                         gstore=gstore, device="cpu")
    refs, stage, compute_step = [], fstore.stage, tr.compute_step

    def tracked_stage(*a):
        staged = stage(*a)
        refs.append(weakref.ref(staged.rows))
        return staged

    def checked_compute_step(*a):
        b = len(refs) - 1  # the batch being computed; batch b+1 is not staged yet
        assert all(r() is None for r in refs[:b]), "staged rows outlive their step"
        return compute_step(*a)

    fstore.stage, tr.compute_step = tracked_stage, checked_compute_step
    graph = None if host_struct else hg.to_device("cpu")
    metrics = tr.train_batches(graph, np.asarray(arrays["labels"], np.int32), _batches(arrays, 5, 32, 0), 2)
    assert len(metrics) == len(refs) == 5 and all(m["stage_h2d_ms"] is None for m in metrics)
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("host_struct", [False, True])
def test_host_residency_learns(host_struct):
    arrays, meta, hg = _problem(6 if host_struct else 0)
    rng = np.random.default_rng(1)
    hot_struct = rng.choice(800, 150, replace=False)
    hot_feat = rng.choice(800, 100, replace=False)  # far smaller than the base
    fstore = tht.HostFeatureStore(arrays["features"], hot_feat, miss_budget=4096, device="cpu")
    gstore = tht.HostCSCStore(hg, hot_struct, miss_budget=4096, deg_cap=32, device="cpu") if host_struct else None
    model = TSAGE(12, 16, 4, 2, dropout=0.0, generator=torch.Generator().manual_seed(0), device="cpu")
    tr = HostTierTrainer(model=model, fan_out=(4, 4), store=fstore, gstore=gstore, device="cpu")
    batches = _batches(arrays, 20 if host_struct else 24, 64, 100 if host_struct else 0)
    metrics = tr.train_batches(None if host_struct else hg.to_device("cpu"), np.asarray(arrays["labels"]),
                               batches, 3 if host_struct else 7)
    assert all(m["feat_overflow"] == 0 for m in metrics) and any(m["feat_miss"] > 0 for m in metrics)
    if host_struct:
        assert all(m["struct_overflow"] == 0 for m in metrics) and any(m["struct_miss"] > 0 for m in metrics)
    else:
        assert all(m["sampler_overflow"] == m["frontier_overflow"] == 0 for m in metrics)
    losses = [float(m["loss"]) for m in metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.85, losses


def _entry_points():
    from dist_gnn_tpu_torch import feature_server
    from dist_gnn_tpu_torch.cache import builder, cost_model
    from dist_gnn_tpu_torch.ops import hashtable

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((50, 4)).astype(np.float32)
    hg = HostGraph.from_coo(rng.integers(0, 50, 200), rng.integers(0, 50, 200), 50)
    return {
        "HostFeatureStore": lambda: tht.HostFeatureStore(feats, np.arange(5), 8),
        "HostCSCStore": lambda: tht.HostCSCStore(hg, np.arange(5), 8),
        "CachedFeatureStore": lambda: feature_server.CachedFeatureStore(feats, np.arange(5)),
        "SortedIdTable.build": lambda: hashtable.SortedIdTable.build(np.arange(5)),
        "build_cache_plan": lambda: builder.build_cache_plan(hg, 4, [np.arange(5)], (2,), 1000),
        "calibrate_host_staging": lambda: cost_model.calibrate_host_staging(4, 64, 16, 1),
        "HostTierTrainer": lambda: HostTierTrainer(
            model=TSAGE(4, 8, 3, 2, device="cpu"), fan_out=(2, 2),
            store=tht.HostFeatureStore(feats, np.arange(5), 8, device="cpu")),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """With no card, each entry point's default device raises rather than
    fall back to the CPU."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
