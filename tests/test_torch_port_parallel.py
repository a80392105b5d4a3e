"""The port's sharded feature store against the JAX package's, world 2.

The JAX side runs in this process on ``make_mesh(2)`` (conftest's CPU
devices); the port's side runs once per module in a spawned world of two
gloo processes (``parallel.mesh.launch``), every case in that one world,
each case its own test.  Inputs are numpy, made from seeds, and the same
on both sides.  Ids, masks, slots, rows and counters must be equal
exactly: the exchange only moves rows.  Rounds are held to the count the
skew implies, ``max over (requester, owner) of ceil(load / budget)``.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dist_gnn_tpu.graph import INVALID_ID
from dist_gnn_tpu.parallel import feature_store as jfs
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu_torch.parallel import feature_store as tfs
from dist_gnn_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
INVALID = int(INVALID_ID)
WORLD = 2


# ---- the port's cases, run on each rank of the spawned world ----------------


def _mine(mesh, a):
    a = np.asarray(a)
    L = a.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(a[mesh.rank * L : (mesh.rank + 1) * L]))


def _case_make_request(mesh, ids, mask, shard_size, budget, owners):
    own = None if owners is None else _mine(mesh, owners)
    plan, recv, ovf = tfs.make_request(_mine(mesh, ids), _mine(mesh, mask), mesh, shard_size, budget, owners=own)
    return plan.slot.numpy(), plan.in_budget.numpy(), recv.numpy(), int(ovf)


def _case_exchange(mesh, feats, ids, mask, budget, lossless, dtype):
    store = tfs.ShardedFeatureStore(torch.from_numpy(feats).to(dtype), mesh)
    syncs = mesh.counts["host_syncs"]
    rows, unserved = tfs.exchange_gather(
        store.features, _mine(mesh, ids), _mine(mesh, mask), mesh, store.shard_size, budget=budget,
        lossless=lossless,
    )
    return rows.float().numpy(), int(unserved), mesh.counts["host_syncs"] - syncs


def _store(mesh, feats, hot, peer_hot, quantize, corrupt):
    store = tfs.ShardedFeatureStore(feats, mesh, hot_ids=hot, peer_hot=peer_hot, quantize=quantize)
    if corrupt is not None:  # the base shards lie about the hot rows; the hot tiers keep the truth
        store.features = store.shard_of(corrupt)
    return store


def _case_peer_hot(mesh, feats, hot, ids, mask, budget, lossless):
    store = _store(mesh, feats, hot, True, False, None)
    syncs = mesh.counts["host_syncs"]
    rows, served = tfs.peer_hot_fetch(
        mesh, store.hot_sorted, store.hot_rows, store.union_sorted, store.union_owner,
        _mine(mesh, ids), _mine(mesh, mask), budget, lossless=lossless,
    )
    return rows.numpy(), served.numpy(), mesh.counts["host_syncs"] - syncs


def _case_fetch_local(mesh, feats, hot, peer_hot, quantize, corrupt, ids, mask, budget):
    store = _store(mesh, feats, hot, peer_hot, quantize, corrupt)
    rows, unserved = store.fetch_local(_mine(mesh, ids), _mine(mesh, mask), budget=budget)
    return rows.numpy(), store.dequantize(rows).numpy(), int(unserved), store.hot_hit_rate(np.asarray(ids))


def _case_fetch(mesh, feats, ids, mask, slack):
    store = tfs.ShardedFeatureStore(feats, mesh, budget_slack=slack)
    rows, unserved = store.fetch(_mine(mesh, ids), _mine(mesh, mask))
    return rows.numpy(), int(unserved)


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


def _rank_fails(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


# ---- inputs -----------------------------------------------------------------

N, F = 600, 8
SS = tfs.shard_rows(N, WORLD)  # 300


def _feats(seed):
    return np.random.default_rng(seed).standard_normal((N, F)).astype(np.float32)


def _skew(seed, L):
    """Every rank asks only for shard 0's rows."""
    return np.random.default_rng(seed).integers(0, SS, WORLD * L).astype(np.int32)


def _cases():
    rng = np.random.default_rng(0)
    c = {}
    ids = rng.integers(0, N, WORLD * 40).astype(np.int32)
    mask = rng.random(WORLD * 40) < 0.8
    ids = np.where(mask, ids, INVALID).astype(np.int32)
    c["mr_uniform"] = (_case_make_request, (ids, mask, SS, 20, None))
    skew = _skew(1, 24)
    c["mr_skew"] = (_case_make_request, (skew, np.ones(WORLD * 24, bool), SS, 5, None))
    owners = rng.integers(-1, WORLD + 1, WORLD * 24).astype(np.int32)
    c["mr_owners"] = (_case_make_request, (skew, rng.random(WORLD * 24) < 0.9, 1, 7, owners))
    feats = _feats(2)
    c["ex_skew_lossless"] = (_case_exchange, (feats, _skew(3, 48), np.ones(WORLD * 48, bool), 6, True, torch.float32))
    c["ex_skew_lossy"] = (_case_exchange, (feats, _skew(4, 32), np.ones(WORLD * 32, bool), 4, False, torch.float32))
    per = np.stack([np.array([5, WORLD * SS + 9, -3, 301], np.int32)] * WORLD).reshape(-1)
    c["ex_out_of_range"] = (_case_exchange, (feats, per, np.ones(per.shape[0], bool), None, True, torch.float32))
    mixed = rng.integers(0, N, WORLD * 64).astype(np.int32)
    mmask = rng.random(WORLD * 64) < 0.9
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8), ("int32", torch.int32)):
        c[f"ex_dtype_{name}"] = (_case_exchange, (feats * 10, mixed, mmask, 9, True, dtype))
    hot = np.stack([rng.choice(N, 40, replace=False).astype(np.int32) for _ in range(WORLD)])
    hot[1, -5:] = INVALID  # a padded tail
    c["peer_lossless"] = (_case_peer_hot, (feats, hot, mixed, mmask, 3, True))
    c["peer_lossy"] = (_case_peer_hot, (feats, hot, mixed, mmask, 3, False))
    perm = rng.permutation(N)[: WORLD * 30].reshape(WORLD, 30).astype(np.int32)  # selfless shape
    corrupt = feats.copy()
    corrupt[perm.reshape(-1)] = -777.0
    c["fl_hot"] = (_case_fetch_local, (feats, hot, False, False, None, mixed, mmask, 64))
    c["fl_hot_skew_tiny_budget"] = (_case_fetch_local, (feats, hot, False, False, None, _skew(5, 32),
                                                        np.ones(WORLD * 32, bool), 4))
    c["fl_peer_corrupted"] = (_case_fetch_local, (feats, perm, True, False, corrupt, mixed, mmask, 64))
    c["fl_hot_no_peer_corrupted"] = (_case_fetch_local, (feats, perm, False, False, corrupt, mixed, mmask, 64))
    qfeats = (feats * rng.uniform(0.5, 5, (N, 1))).astype(np.float32)
    c["fl_quantized_peer"] = (_case_fetch_local, (qfeats, perm, True, True, None, mixed, mmask, 64))
    c["fetch_tight_slack"] = (_case_fetch, (feats, _skew(6, 64), np.ones(WORLD * 64, bool), 0.5))
    return c


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    results = tmesh.launch(_run_cases, WORLD, args=(CASES,), device="cpu", timeout_s=240)
    return results


def _ranks(port, name):
    out = []
    for r in range(WORLD):
        status, payload = port[r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(WORLD)


def _smap(jmesh, body, in_specs, out_specs, *args):
    return jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))(*args)


def _split(a):
    a = np.asarray(a)
    return np.split(a, WORLD)


def _pair_rounds(ids, mask, budget):
    """Rounds a lossless exchange needs: the largest (requester, owner)
    load over the budget, rounded up (at least one)."""
    worst = 0
    for i, m in zip(_split(ids), _split(mask)):
        owner = np.clip(i[m] // SS, 0, WORLD - 1)
        worst = max(worst, np.bincount(owner, minlength=WORLD).max(initial=0))
    return max(1, -(-worst // budget))


# ---- tests ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mr_uniform", "mr_skew", "mr_owners"])
def test_make_request_matches_jax(port, jmesh, name):
    _, (ids, mask, ss, budget, owners) = CASES[name]

    def body(i, m, o):
        plan, recv, ovf = jfs.make_request(i, m, "data", ss, budget, owners=None if owners is None else o)
        return plan.slot, plan.in_budget, recv, ovf[None]

    o = owners if owners is not None else np.zeros_like(ids)
    js, jb, jr, jo = _smap(jmesh, body, (P("data"),) * 3, (P("data"),) * 4,
                           jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(o))
    for r, (slot, in_budget, recv, ovf) in enumerate(_ranks(port, name)):
        np.testing.assert_array_equal(slot, _split(js)[r])
        np.testing.assert_array_equal(in_budget, _split(jb)[r])
        np.testing.assert_array_equal(recv, _split(jr)[r])
        assert ovf == int(np.asarray(jo)[r])
    if name == "mr_skew":
        assert sum(o for *_, o in _ranks(port, name)) == WORLD * (24 - 5)


@pytest.mark.parametrize("name", ["ex_skew_lossless", "ex_skew_lossy", "ex_out_of_range",
                                  "ex_dtype_bf16", "ex_dtype_int8", "ex_dtype_int32"])
def test_exchange_gather_matches_jax(port, jmesh, name):
    _, (feats, ids, mask, budget, lossless, dtype) = CASES[name]
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
              torch.int32: jnp.int32}[dtype]
    store = jfs.ShardedFeatureStore(np.asarray(jnp.asarray(feats).astype(jdtype)), jmesh)

    def body(shard, i, m):
        rows, uns = jfs.exchange_gather(shard, i, m, "data", SS, budget=budget, lossless=lossless)
        return rows, uns[None]

    jrows, juns = _smap(jmesh, body, (P("data", None), P("data"), P("data")), (P("data"), P("data")),
                        store.features, jnp.asarray(ids), jnp.asarray(mask))
    jrows = np.asarray(jrows.astype(jnp.float32))
    for r, (rows, unserved, rounds) in enumerate(_ranks(port, name)):
        np.testing.assert_array_equal(rows, _split(jrows)[r])
        assert unserved == int(np.asarray(juns)[r])
        if lossless:
            in_range = mask & (ids >= 0) & (ids < WORLD * SS)
            assert rounds == _pair_rounds(ids, in_range, budget or tfs.request_budget(len(ids) // WORLD, WORLD))
        else:
            assert rounds == 0
    if name == "ex_skew_lossless":
        assert all(rd == 8 for *_, rd in _ranks(port, name))  # per-pair load 48, budget 6
        np.testing.assert_array_equal(np.concatenate([x[0] for x in _ranks(port, name)]), feats[ids])
    if name == "ex_skew_lossy":
        assert sum(u for _, u, _ in _ranks(port, name)) == WORLD * (32 - 4)
    if name == "ex_out_of_range":
        assert all(u == 2 for _, u, _ in _ranks(port, name))
        for rows, _, _ in _ranks(port, name):
            np.testing.assert_array_equal(rows[0], feats[5])
            np.testing.assert_array_equal(rows[3], feats[301])
            assert (rows[1:3] == 0).all()


def _jax_store_args(store):
    return store.shard_args(), store.shard_specs()


@pytest.mark.parametrize("name", ["peer_lossless", "peer_lossy"])
def test_peer_hot_fetch_matches_jax(port, jmesh, name):
    _, (feats, hot, ids, mask, budget, lossless) = CASES[name]
    store = jfs.ShardedFeatureStore(feats, jmesh, hot_ids=hot, peer_hot=True)
    args, specs = _jax_store_args(store)

    def body(a, i, m):
        _, hs, hr, us, uo = a
        rows, served = jfs.peer_hot_fetch("data", hs.reshape(-1), hr.reshape(hr.shape[-2], hr.shape[-1]),
                                          us, uo, i, m, budget, lossless=lossless)
        return rows, served

    jrows, jserved = _smap(jmesh, body, (specs, P("data"), P("data")), (P("data"), P("data")),
                           args, jnp.asarray(ids), jnp.asarray(mask))
    for r, (rows, served, rounds) in enumerate(_ranks(port, name)):
        np.testing.assert_array_equal(rows, _split(jrows)[r])
        np.testing.assert_array_equal(served, _split(jserved)[r])
        assert (rounds >= 1) == lossless
    if lossless:  # every id hot somewhere was served, from a hot tier
        hot_any = np.isin(ids, hot[hot != INVALID]) & mask
        served = np.concatenate([s for _, s, _ in _ranks(port, name)])
        np.testing.assert_array_equal(served, hot_any)
        np.testing.assert_array_equal(np.concatenate([x[0] for x in _ranks(port, name)])[hot_any],
                                      feats[ids[hot_any]])
    else:
        assert not np.concatenate([s for _, s, _ in _ranks(port, name)]).all()


@pytest.mark.parametrize("name", ["fl_hot", "fl_hot_skew_tiny_budget", "fl_peer_corrupted",
                                  "fl_hot_no_peer_corrupted", "fl_quantized_peer"])
def test_fetch_local_matches_jax(port, jmesh, name):
    _, (feats, hot, peer_hot, quantize, corrupt, ids, mask, budget) = CASES[name]
    from jax.sharding import NamedSharding

    store = jfs.ShardedFeatureStore(feats, jmesh, hot_ids=hot, peer_hot=peer_hot, quantize=quantize)
    if corrupt is not None:
        padded = np.zeros((SS * WORLD, F), np.float32)
        padded[:N] = corrupt
        store.features = jax.device_put(padded, NamedSharding(jmesh, P("data", None)))
    args, specs = _jax_store_args(store)

    def body(a, i, m):
        rows, uns = store.fetch_local(a, i, m, budget=budget)
        return rows, store.dequantize(rows), uns[None]

    jrows, jdeq, juns = _smap(jmesh, body, (specs, P("data"), P("data")), (P("data"),) * 3,
                              args, jnp.asarray(ids), jnp.asarray(mask))
    for r, (rows, deq, unserved, _) in enumerate(_ranks(port, name)):
        np.testing.assert_array_equal(rows, _split(jrows)[r])
        np.testing.assert_array_equal(deq, _split(jdeq)[r])
        assert unserved == int(np.asarray(juns)[r]) == 0
    got = np.concatenate([x[1] for x in _ranks(port, name)])
    want = np.where(mask[:, None], feats[np.where(mask, ids, 0)], 0)
    if name == "fl_peer_corrupted":  # every row true: hot rows never come from the lying base
        np.testing.assert_array_equal(got, want)
    if name == "fl_hot_no_peer_corrupted":  # remote-hot rows come from the base without peer_hot
        local_hot = np.concatenate([np.isin(i, hot[r]) for r, i in enumerate(_split(ids))])
        remote_hot = np.isin(ids, hot.reshape(-1)) & ~local_hot & mask
        assert remote_hot.any() and (got[remote_hot] == -777.0).all()
    if name == "fl_quantized_peer":
        rel = np.abs(got - want).max(1) / np.maximum(np.abs(want).max(1), 1e-9)
        assert rel[mask].max() < 0.01
    if name == "fl_hot":
        assert _ranks(port, name)[0][3] > 0


def test_store_fetch_matches_jax(port, jmesh):
    _, (feats, ids, mask, slack) = CASES["fetch_tight_slack"]
    store = jfs.ShardedFeatureStore(feats, jmesh, budget_slack=slack)
    jrows, juns = jax.jit(store.fetch)(jnp.asarray(ids), jnp.asarray(mask))
    res = _ranks(port, "fetch_tight_slack")
    np.testing.assert_array_equal(np.concatenate([x[0] for x in res]), np.asarray(jrows))
    assert all(u == int(juns) == 0 for _, u in res)
    np.testing.assert_array_equal(np.asarray(jrows), feats[ids])


@pytest.mark.parametrize("C", [1, 7, 30])
def test_build_union_tables_matches_jax(C):
    rng = np.random.default_rng(C)
    hot = rng.integers(0, 200, (4, C)).astype(np.int32)  # overlaps between ranks
    hot[rng.random((4, C)) < 0.2] = INVALID
    us, uo = tfs.build_union_tables(hot)
    jus, juo = jfs.build_union_tables(hot)
    np.testing.assert_array_equal(us, jus)
    np.testing.assert_array_equal(uo, juo)
    assert us.dtype == uo.dtype == np.int32


def test_request_budget_and_shard_rows_match_jax():
    for n_ids in (1, 7, 64, 540_672):
        for n in (1, 2, 3, 8):
            assert tfs.shard_rows(n_ids, n) == jfs.shard_rows(n_ids, n)
            for slack in (0.5, 1.0, 2.0, 4.0):
                assert tfs.request_budget(n_ids, n, slack) == jfs.request_budget(n_ids, n, slack)


def test_replicate_to_mesh_and_axis_size():
    mesh = tmesh.Mesh(rank=1, size=2, device=torch.device("cpu"))
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "ids": [np.array([1, 2], np.int32), torch.ones(2)]}
    out = tmesh.replicate_to_mesh(tree, mesh)
    assert isinstance(out["ids"], list) and out["w"].dtype == torch.float32 and out["ids"][0].dtype == torch.int32
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    assert tmesh.axis_size(mesh) == 2 == mesh.size


def test_make_mesh_needs_a_process_group_and_nccl_a_card():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh("cpu")
    with pytest.raises(ValueError, match="NCCL"):
        tmesh.initialize_distributed("file:///nonexistent", 0, 1, backend="nccl", device="cpu")


def test_launch_returns_a_failing_rank_s_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.launch(_rank_fails, WORLD, device="cpu", timeout_s=120)


def test_launch_defaults_to_the_card_and_raises_without_one(monkeypatch):
    # the device is resolved before any rank is spawned
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.launch(_rank_fails, WORLD, timeout_s=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.launch(_rank_fails, WORLD, backend="gloo", device="cuda", timeout_s=5)
