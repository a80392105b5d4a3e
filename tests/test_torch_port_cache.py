"""Cache planning and the single-device stores: the port against the JAX
package on the same numpy inputs (JAX on the CPU).

Tolerances: ``SortedIdTable`` and the feature stores exact (lookups and
row copies); heats 1e-5 relative (f32 sums in another order); the policy
on JAX's own heats and ``build_cache_plan`` identical plans and mode;
``CostModel`` arithmetic equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import feature_server as jfs
from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu.cache import builder as jbuilder
from dist_gnn_tpu.cache import cost_model as jcost
from dist_gnn_tpu.cache import policy as jpolicy
from dist_gnn_tpu.ops import hashtable as jht
from dist_gnn_tpu.ops import heat as jheat
from dist_gnn_tpu_torch import feature_server as tfs
from dist_gnn_tpu_torch.cache import builder, cost_model, policy
from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
from dist_gnn_tpu_torch.ops import gather, hashtable, heat

torch.set_num_threads(1)
HEAT_RTOL = 1e-5


def _graph(seed, n=240, e=1500, weighted=False):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), (rng.pareto(1.5, e) * 7).astype(np.int64) % n
    probs = (rng.random(e) + 0.05).astype(np.float32) if weighted else None
    thg = HostGraph.from_coo(src, dst, n, probs=probs)
    jhg = jgraph.HostGraph(indptr=thg.indptr, indices=thg.indices, probs=thg.probs)
    return thg, jhg, rng


# ---- ops/hashtable ------------------------------------------------------


def test_np_in_sorted_is_jax_s():
    table = np.array([2, 5, 9, 40], np.int32)
    ids = np.array([0, 2, 3, 9, 40, 41, INVALID_ID])
    for a, b in zip(hashtable.np_in_sorted(table, ids), jht.np_in_sorted(table, ids)):
        np.testing.assert_array_equal(a, b)
    member, pos = hashtable.np_in_sorted(np.zeros(0, np.int32), ids)
    assert not member.any() and (pos == 0).all()


@pytest.mark.parametrize("with_priority", [False, True])
def test_sorted_id_table_matches_jax(with_priority):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 60, 80).astype(np.int32)  # many duplicates
    priority = rng.integers(0, 2, 80).astype(np.int32) if with_priority else None  # 0 local, 1 remote
    t = hashtable.SortedIdTable.build(ids, priority, device="cpu")
    j = jht.SortedIdTable.build(ids, priority=priority)
    np.testing.assert_array_equal(t.sorted_ids_np, np.asarray(j.sorted_ids))
    np.testing.assert_array_equal(t.slots.numpy(), np.asarray(j.slots))
    q = np.concatenate([rng.integers(-5, 70, 200), [INVALID_ID]]).astype(np.int32)
    ts, th = t.lookup(torch.from_numpy(q))
    js, jh = j.lookup(jnp.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_sorted_id_table_empty():
    t = hashtable.SortedIdTable.build(np.zeros(0, np.int32), device="cpu")
    s, h = t.lookup(torch.tensor([0, 3], dtype=torch.int32))
    assert s.tolist() == [0, 0] and h.tolist() == [False, False]


# ---- feature_server ------------------------------------------------------


def _query(rng, n, L=150):
    nids = rng.integers(0, n, L).astype(np.int32)
    mask = rng.random(L) < 0.85
    nids[~mask] = INVALID_ID
    return nids, mask


def test_hbm_feature_store_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((200, 9)).astype(np.float32)
    nids, mask = _query(rng, 200)
    want = jfs.HBMFeatureStore(jnp.asarray(feats)).get_features(jnp.asarray(nids), jnp.asarray(mask))
    got = tfs.HBMFeatureStore(torch.from_numpy(feats)).get_features(torch.from_numpy(nids), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_default = tfs.HBMFeatureStore(torch.from_numpy(feats)).get_features(torch.from_numpy(nids))
    np.testing.assert_array_equal(got_default.numpy(), np.asarray(want))


def test_cached_feature_store_matches_jax_on_a_padded_plan():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((300, 7)).astype(np.float32)
    plan = np.full(90, INVALID_ID, np.int32)  # a cache plan row, INVALID padded
    plan[:60] = rng.choice(300, 60, replace=False)
    plan[60] = 300  # out of range: dropped as the JAX store drops it
    nids, mask = _query(rng, 300)
    js = jfs.CachedFeatureStore(feats, plan)
    ts = tfs.CachedFeatureStore(feats, plan, device="cpu")
    want = js.get_features(jnp.asarray(nids), jnp.asarray(mask))
    got = ts.get_features(torch.from_numpy(nids), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.where(mask[:, None], feats[np.where(mask, nids, 0)], 0))
    assert ts.hit_rate(nids[mask]) == pytest.approx(js.hit_rate(nids[mask]))
    assert 0 < ts.hit_rate(nids[mask]) < 1
    assert gather.gather_rows.launches == 0


# ---- ops/heat ------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_get_node_heat_matches_jax(weighted):
    thg, jhg, rng = _graph(7, weighted=weighted)
    train = rng.choice(thg.num_nodes, 50, replace=False).astype(np.int32)
    fan_out = (4, 3)
    js, jf = jheat.get_node_heat(jhg.to_device(), jnp.asarray(train), fan_out)
    ts, tf = heat.get_node_heat(thg.to_device("cpu"), train, fan_out)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=HEAT_RTOL, atol=1e-7)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=HEAT_RTOL, atol=1e-7)
    assert (tf.numpy() > 0).sum() > 100
    step = heat.frontier_heat_step(thg.to_device("cpu"), torch.from_numpy((np.arange(240) % 3 == 0).astype(np.float32)), 5)
    jstep = jheat.frontier_heat_step(jhg.to_device(), jnp.asarray((np.arange(240) % 3 == 0).astype(np.float32)), 5)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=HEAT_RTOL, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_heat_all_devices_chunked_and_host_streamed_match_jax(weighted):
    thg, jhg, rng = _graph(8, weighted=weighted)
    D, N = 3, thg.num_nodes
    seeds = np.zeros((D, N), np.float32)
    for d in range(D):
        seeds[d, rng.choice(N, 30, replace=False)] = 1.0
    fan_out = (3, 2, 2)
    chunk = 97  # chunks split rows
    js, jf = jheat.get_node_heat_all(jhg.to_device(), jnp.asarray(seeds), fan_out, chunk=chunk)
    ts, tf = heat.get_node_heat_all(thg.to_device("cpu"), torch.from_numpy(seeds), fan_out, chunk=chunk)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=HEAT_RTOL, atol=1e-7)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=HEAT_RTOL, atol=1e-7)
    # host-streamed, device groups of 1 (a budget that holds one [N] group)
    budget = 4 * N * 4 + 8 * N
    hs, hf = heat.get_node_heat_all_host(thg, seeds, fan_out, chunk=chunk, device_budget_bytes=budget, device="cpu")
    jhs, jhf = jheat.get_node_heat_all_host(jhg, seeds, fan_out, chunk=chunk, device_budget_bytes=budget)
    np.testing.assert_allclose(hs, jhs, rtol=HEAT_RTOL, atol=1e-7)
    np.testing.assert_allclose(hf, jhf, rtol=HEAT_RTOL, atol=1e-7)
    np.testing.assert_allclose(hf, tf.numpy(), rtol=HEAT_RTOL, atol=1e-7)


def test_host_chunk_rows_is_jax_s():
    thg, _, _ = _graph(9)
    ip = thg.indptr.astype(np.int64)
    for e0, e1 in ((0, 1), (0, 97), (500, 777), (1400, 1500)):
        np.testing.assert_array_equal(heat._host_chunk_rows(ip, e0, e1), jheat._host_chunk_rows(ip, e0, e1))


# ---- cache/policy and cache/builder --------------------------------------


def _jax_heats(jhg, parts, fan_out):
    return jbuilder.compute_heats(jhg, parts, fan_out)


@pytest.mark.parametrize("D", [1, 3])
def test_policy_on_jax_heats_is_identical(D):
    thg, jhg, rng = _graph(10)
    parts = [rng.choice(thg.num_nodes, 40, replace=False) for _ in range(D)]
    s_h, f_h = _jax_heats(jhg, parts, (3, 3))
    jc, tc = jcost.CostModel(), cost_model.CostModel()
    cap = 3000
    for tfn, jfn in ((policy.get_cache_nids_selfish, jpolicy.get_cache_nids_selfish),
                     (policy.get_cache_nids_selfless, jpolicy.get_cache_nids_selfless)):
        for frb in (None, 2 * 16):
            tp = tfn(thg, 16, s_h, f_h, cap, tc, frb)
            jp = jfn(jhg, 16, s_h, f_h, cap, jc, frb)
            for (ts_, tf_), (js_, jf_) in zip(tp, jp):
                np.testing.assert_array_equal(ts_, js_)
                np.testing.assert_array_equal(tf_, jf_)
                assert len(ts_) + len(tf_) > 0
            assert policy.score_selfish(thg, 16, (s_h, f_h), tp, tc, frb) == jpolicy.score_selfish(
                jhg, 16, (s_h, f_h), jp, jc, frb)
            assert policy.score_selfless(thg, 16, (s_h, f_h), tp, tc, frb) == jpolicy.score_selfless(
                jhg, 16, (s_h, f_h), jp, jc, frb)
    tm, tp = policy.get_cache_nids_auto(thg, 16, s_h, f_h, cap, tc)
    jm, jp = jpolicy.get_cache_nids_auto(jhg, 16, s_h, f_h, cap, jc)
    assert tm == jm
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(policy.structure_space_bytes(thg, np.arange(20)),
                                  jpolicy.structure_space_bytes(jhg, np.arange(20)))


def _plan_fixture():
    """A weighted 60-node graph whose knapsack values (heat over bytes,
    structure and feature candidates of each device together) are
    pairwise distinct beyond the heats' tolerance, so f32 rounding cannot
    reorder the plan."""
    rng = np.random.default_rng(0)
    n, e = 60, 700
    thg = HostGraph.from_coo(rng.integers(0, n, e), rng.integers(0, n, e), n,
                             probs=(rng.random(e) + 0.05).astype(np.float32))
    jhg = jgraph.HostGraph(indptr=thg.indptr, indices=thg.indices, probs=thg.probs)
    return thg, jhg, [rng.choice(n, 6, replace=False) for _ in range(2)]


def _knapsack_values(jhg, s_h, f_h, feature_row_bytes):
    c = jcost.CostModel()
    for d in range(s_h.shape[0]):
        sn, fn = np.flatnonzero(s_h[d]), np.flatnonzero(f_h[d])
        yield np.concatenate([
            s_h[d][sn] / jpolicy.structure_space_bytes(jhg, sn) * c.sampling_reduced_time(),
            f_h[d][fn] / feature_row_bytes * c.feature_reduced_time(),
        ])


@pytest.mark.parametrize("policy_name,hot_dtype", [("auto", None), ("selfish", torch.bfloat16), ("selfless", None)])
def test_build_cache_plan_matches_jax(policy_name, hot_dtype):
    thg, jhg, parts = _plan_fixture()
    fan_out = (3, 2)
    s_h, f_h = _jax_heats(jhg, parts, fan_out)
    frb = 16 * (4 if hot_dtype is None else 2)
    for v in _knapsack_values(jhg, s_h, f_h, frb):
        v = np.sort(v)
        assert len(v) > 50 and np.min(np.diff(v) / np.abs(v[1:])) > HEAT_RTOL
    ts_h, tf_h = builder.compute_heats(thg, parts, fan_out, device="cpu")
    np.testing.assert_allclose(ts_h, s_h, rtol=HEAT_RTOL, atol=1e-7)
    np.testing.assert_allclose(tf_h, f_h, rtol=HEAT_RTOL, atol=1e-7)
    cap = 2500
    jdt = None if hot_dtype is None else "bf16"
    tm, ts, tf = builder.build_cache_plan(thg, 16, parts, fan_out, cap, policy_name, hot_dtype=hot_dtype, device="cpu")
    jm, js, jf = jbuilder.build_cache_plan(jhg, 16, parts, fan_out, cap, policy_name, hot_dtype=jdt)
    assert tm == jm
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tf, jf)
    assert ts.dtype == tf.dtype == np.int32 and (ts != INVALID_ID).any() and (tf != INVALID_ID).any()
    # past the planning budget the heats stream from the host: same plan
    hm, hs, hf = builder.build_cache_plan(thg, 16, parts, fan_out, cap, policy_name, hot_dtype=hot_dtype,
                                          device_budget_bytes=1, device="cpu")
    assert hm == tm
    np.testing.assert_array_equal(hs, ts)
    np.testing.assert_array_equal(hf, tf)


def test_pad_plans_is_jax_s():
    plans = [np.array([3, 1, 2]), np.array([], np.int64), np.array([7])]
    np.testing.assert_array_equal(builder._pad_plans(plans), jbuilder._pad_plans(plans))
    np.testing.assert_array_equal(builder._pad_plans(plans, 2), jbuilder._pad_plans(plans, 2))


def test_build_cache_plan_refuses_an_integer_hot_dtype():
    """int8 is the packed quantized row (F + 4 bytes); any other integer
    dtype has no row layout and is refused."""
    thg, _, _ = _graph(12)
    for dtype in (torch.int16, torch.int32):
        with pytest.raises(ValueError):
            builder.build_cache_plan(thg, 16, [np.arange(10)], (2,), 1000, hot_dtype=dtype, device="cpu")


# ---- cache/cost_model ----------------------------------------------------


def test_cost_model_arithmetic_equals_jax():
    kw = dict(bandwidth_hbm=2.0e12, bandwidth_ici=1.1e11, bandwidth_host=2.3e10)
    t, j = cost_model.CostModel(**kw), jcost.CostModel(**kw)
    assert t.sampling_reduced_time() == j.sampling_reduced_time()
    assert t.feature_reduced_time() == j.feature_reduced_time()
    for d in (1, 2, 8, 40):
        assert t.local_bandwidth_selfless(d) == j.local_bandwidth_selfless(d)
    names = [f.name for f in dataclasses.fields(jcost.CostModel)]
    assert [f.name for f in dataclasses.fields(cost_model.CostModel)] == names
    assert cost_model.CostModel() == cost_model.CostModel(**{k: getattr(jcost.CostModel(), k) for k in names})


def test_calibrate_host_staging_on_the_cpu():
    cm = cost_model.calibrate_host_staging(feature_dim=8, base_rows=512, batch_rows=128, reps=2, device="cpu")
    assert cm.staging_gather_bandwidth > 0 and cm.staging_h2d_bandwidth > 0
    assert cm.bandwidth_host == pytest.approx(
        1.0 / (1.0 / cm.staging_gather_bandwidth + 1.0 / cm.staging_h2d_bandwidth))


def test_device_measurements_refuse_the_cpu():
    with pytest.raises(ValueError):
        cost_model.calibrate(device="cpu")
    with pytest.raises(ValueError):
        cost_model.available_hbm_bytes("cpu")
