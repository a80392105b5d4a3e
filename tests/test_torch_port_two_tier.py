"""The two-tier ``('host', 'data')`` mesh and the hierarchical exchange
against the JAX package's, world 4.

The JAX side runs in this process on ``make_mesh(4, ("host", "data"),
hosts=H)`` (conftest's CPU devices); the port's side runs once per module
in one spawned world of four gloo processes (``parallel.mesh.launch``),
which builds the meshes ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` in that one
world and runs every case there, each case its own test.  Inputs are
numpy, made from seeds, and the same on both sides.  The layout, union
tables, rows, unserved counts and round counts must be equal exactly: the
exchange only moves rows.  Rounds are held to a numpy model of the two
stages (``_hier_rounds``) and the collectives to two all_to_alls a stage
and one world all-reduce a round.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from dist_gnn_tpu.graph import INVALID_ID
from dist_gnn_tpu.parallel import feature_store as jfs
from dist_gnn_tpu.parallel.mesh import axis_size as jaxis_size
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu_torch.parallel import feature_store as tfs
from dist_gnn_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
INVALID = int(INVALID_ID)
WORLD = 4
HOSTS = (2, 1, 4)
AX = ("host", "data")
N, F, L = 600, 8, 48
SS = tfs.shard_rows(N, WORLD)  # 150


# ---- the port's cases, run on each rank of the spawned world ----------------


def _mine(mesh, a):
    a = np.asarray(a)
    n = a.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(a[mesh.rank * n : (mesh.rank + 1) * n]))


def _case_layout(mesh):
    subs = {k: (m.rank, m.size, dist.get_process_group_ranks(m.group) if m.group is not None
                else list(range(dist.get_world_size()))) for k, m in mesh.subs.items()}
    sizes = {str(a): tmesh.axis_size(mesh, a) for a in ("host", "data", AX)}
    return mesh.shape, subs, sizes, mesh.axis(AX) is mesh


def _case_exchange(mesh, feats, ids, mask, bh, bd, lossless, dtype):
    store = tfs.ShardedFeatureStore(torch.from_numpy(feats).to(dtype), mesh, axis_name=AX, hierarchical=True)
    mesh.reset_counts()
    rows, unserved = tfs.exchange_gather_hier(store.features, _mine(mesh, ids), _mine(mesh, mask), mesh,
                                              store.shard_size, budget_host=bh, budget_data=bd, lossless=lossless)
    return rows.float().numpy(), int(unserved), mesh.all_counts()


def _case_hier_vs_flat(mesh, feats, ids, mask):
    hier = tfs.ShardedFeatureStore(feats, mesh, axis_name=AX, hierarchical=True)
    flat = tfs.ShardedFeatureStore(feats, mesh, axis_name=AX)
    i, m = _mine(mesh, ids), _mine(mesh, mask)
    rh, uh = hier.fetch_local(i, m)
    rf, uf = flat.fetch_local(i, m)
    rx, ux = tfs.exchange_gather(hier.features, i, m, mesh, hier.shard_size)
    return rh.numpy(), int(uh), rf.numpy(), int(uf), rx.numpy(), int(ux)


def _case_store(mesh, feats, hot, peer_hot, quantize, corrupt, ids, mask, budget):
    store = tfs.ShardedFeatureStore(feats, mesh, axis_name=AX, hot_ids=hot, peer_hot=peer_hot, quantize=quantize,
                                    hierarchical=True)
    if corrupt is not None:  # the base shards lie about the hot rows; the hot tiers keep the truth
        store.features = store.shard_of(corrupt)
    mesh.reset_counts()
    rows, unserved = store.fetch_local(_mine(mesh, ids), _mine(mesh, mask), budget=budget)
    return rows.numpy(), store.dequantize(rows).numpy(), int(unserved), mesh.all_counts()


def _case_fetch(mesh, feats, ids, mask, slack):
    store = tfs.ShardedFeatureStore(feats, mesh, axis_name=AX, budget_slack=slack, hierarchical=True)
    rows, unserved = store.fetch(_mine(mesh, ids), _mine(mesh, mask))
    return rows.numpy(), int(unserved), store.request_budget_for(L)


def _run_cases(mesh, cases):
    meshes = {H: tmesh.make_mesh("cpu", hosts=H) for H in HOSTS}  # every rank, in one order
    out = {}
    for name, (H, fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(meshes[H], *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


# ---- inputs -----------------------------------------------------------------


def _feats(seed):
    return np.random.default_rng(seed).standard_normal((N, F)).astype(np.float32)


def _ids(seed, hi, lo=0, p_mask=1.0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, hi, WORLD * L).astype(np.int32)
    mask = rng.random(WORLD * L) < p_mask
    return np.where(mask, ids, INVALID).astype(np.int32), mask


def _selfless(seed, C=24):
    return np.random.default_rng(seed).permutation(N)[: WORLD * C].reshape(WORLD, C).astype(np.int32)


EXCHANGE = {  # name -> (ids seed, id range, budget_host, budget_data, lossless)
    "skew_shard0": (1, SS, 5, None, True),  # every id in shard 0: the host stage binds
    "skew_host0_tight_data": (2, 2 * SS, 16, 3, True),  # stage 2 drops, rounds repeat both stages
    "lossy": (3, N, 4, 5, False),
    "defaults": (4, N, None, None, True),
}


def _cases():
    c = {}
    feats = _feats(0)
    for H in HOSTS:
        c[f"layout_{H}"] = (H, _case_layout, ())
        for name, (seed, hi, bh, bd, lossless) in EXCHANGE.items():
            ids, mask = _ids(seed + 10 * H, hi, p_mask=0.9 if name == "defaults" else 1.0)
            c[f"ex_{name}_{H}"] = (H, _case_exchange, (feats, ids, mask, bh, bd, lossless, torch.float32))
        oor = np.stack([np.array([5, WORLD * SS + 9, -3, SS + 1], np.int32)] * WORLD).reshape(-1)
        c[f"ex_out_of_range_{H}"] = (H, _case_exchange, (feats, oor, np.ones(oor.shape[0], bool), None, None,
                                                          True, torch.float32))
        ids, mask = _ids(5 + H, N, p_mask=0.85)
        c[f"hier_vs_flat_{H}"] = (H, _case_hier_vs_flat, (feats, ids, mask))
        perm = _selfless(6 + H)
        corrupt = feats.copy()
        corrupt[perm.reshape(-1)] = -777.0
        ids, mask = _ids(7 + H, N)
        c[f"st_plain_{H}"] = (H, _case_store, (feats, None, False, False, None, ids, mask, None))
        c[f"st_hot_{H}"] = (H, _case_store, (feats, perm, False, False, None, ids, mask, L))
        c[f"st_peer_corrupt_{H}"] = (H, _case_store, (feats, perm, True, False, corrupt, ids, mask, L))
        qfeats = (feats * np.random.default_rng(8).uniform(0.5, 5, (N, 1))).astype(np.float32)
        c[f"st_quant_peer_{H}"] = (H, _case_store, (qfeats, perm, True, True, None, ids, mask, L))
        skew, smask = _ids(9 + H, SS)
        c[f"fetch_tight_{H}"] = (H, _case_fetch, (feats, skew, smask, 0.5))
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        ids, mask = _ids(11, N, p_mask=0.9)
        c[f"ex_dtype_{name}"] = (2, _case_exchange, (feats * 10, ids, mask, 6, None, True, dtype))
    return c


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    return tmesh.launch(_run_cases, WORLD, args=(CASES,), device="cpu", timeout_s=300)


def _ranks(port, name):
    out = []
    for r in range(WORLD):
        status, payload = port[r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


_JMESHES = {}


def _jmesh(H):
    if H not in _JMESHES:
        _JMESHES[H] = jmake_mesh(WORLD, AX, hosts=H)
    return _JMESHES[H]


def _smap(jmesh, body, in_specs, out_specs, *args):
    return jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))(*args)


def _split(a):
    return np.split(np.asarray(a), WORLD)


def _hier_rounds(ids, mask, H, bh, bd):
    """Rounds of the lossless two-stage exchange, modelled in numpy: stage 1
    ranks each requester's pending ids within their owner host (budget bh)
    and relays them to the chip of the requester's intra-host index there,
    whose table (requester hosts in order) stage 2 ranks within the owner
    chip (budget bd); an id is served when it passed both."""
    D = WORLD // H
    n = WORLD
    ids, mask = ids.reshape(n, -1), mask.reshape(n, -1)
    pending = mask & (ids >= 0) & (ids < n * SS)
    rounds = 0
    while True:
        rounds += 1
        relay = [[[] for _ in range(H)] for _ in range(n)]  # [dest chip][source host] -> (c, i)
        for c in range(n):
            load = np.zeros(H, int)
            for i in np.flatnonzero(pending[c]):
                oh = min(max(ids[c, i] // SS, 0), n - 1) // D
                if load[oh] < bh:
                    relay[oh * D + c % D][c // D].append((c, i))
                load[oh] += 1
        served = np.zeros_like(pending)
        for dest in range(n):
            load = np.zeros(D, int)
            for c, i in (e for src in relay[dest] for e in src):
                oc = (ids[c, i] // SS) % D
                if load[oc] < bd:
                    served[c, i] = True
                load[oc] += 1
        pending &= ~served
        if not pending.any():
            return rounds


# ---- tests ------------------------------------------------------------------


@pytest.mark.parametrize("H", HOSTS)
def test_mesh_layout_and_axis_size_match_jax(port, H):
    jmesh = _jmesh(H)
    D = WORLD // H
    pos = {d.id: i for i, d in enumerate(jax.devices())}
    grid = np.vectorize(lambda d: pos[d.id])(jmesh.devices)  # flat index at (h, d)
    for r, (shape, subs, sizes, tuple_is_world) in enumerate(_ranks(port, f"layout_{H}")):
        h, d = r // D, r % D
        assert tuple(shape) == tuple(jmesh.devices.shape) == (H, D)
        assert grid[h, d] == r  # the flat index of the tuple axis is the rank
        assert subs["host"] == (h, H, grid[:, d].tolist())
        assert subs["data"] == (d, D, grid[h, :].tolist())
        assert sizes == {"host": jaxis_size(jmesh, "host"), "data": jaxis_size(jmesh, "data"),
                         str(AX): jaxis_size(jmesh, AX)}
        assert tuple_is_world


@pytest.mark.parametrize("H", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 7, 30])
def test_build_union_tables_per_host_matches_jax(H, C):
    rng = np.random.default_rng(10 * H + C)
    hot = rng.integers(0, 200, (WORLD, C)).astype(np.int32)  # overlaps between ranks
    hot[rng.random((WORLD, C)) < 0.2] = INVALID
    us, uo = tfs.build_union_tables(hot, num_hosts=H)
    jus, juo = jfs.build_union_tables(hot, num_hosts=H)
    np.testing.assert_array_equal(us, jus)
    np.testing.assert_array_equal(uo, juo)
    assert us.dtype == uo.dtype == np.int32 and us.shape == ((H, us.shape[-1]) if H > 1 else us.shape)
    if H > 1:  # owners are intra-host indices, each host's table its own ranks' ids
        D = WORLD // H
        assert uo.max() < D
        for h in range(H):
            mine = np.unique(hot[h * D : (h + 1) * D][hot[h * D : (h + 1) * D] != INVALID])
            np.testing.assert_array_equal(us[h][us[h] != INVALID], mine)


def _jax_exchange(H, feats, ids, mask, bh, bd, lossless, jdtype):
    jmesh = _jmesh(H)
    store = jfs.ShardedFeatureStore(np.asarray(jnp.asarray(feats).astype(jdtype)), jmesh, axis_name=AX,
                                    hierarchical=True)

    def body(shard, i, m):
        rows, uns = jfs.exchange_gather_hier(shard, i, m, "host", "data", SS, budget_host=bh, budget_data=bd,
                                             lossless=lossless)
        return rows, uns[None]

    rows, uns = _smap(jmesh, body, (P(AX, None), P(AX), P(AX)), (P(AX), P(AX)),
                      store.features, jnp.asarray(ids), jnp.asarray(mask))
    return np.asarray(rows.astype(jnp.float32)), np.asarray(uns)


EX_NAMES = [f"ex_{name}_{H}" for H in HOSTS for name in (*EXCHANGE, "out_of_range")] + ["ex_dtype_bf16",
                                                                                         "ex_dtype_int8"]


@pytest.mark.parametrize("name", EX_NAMES)
def test_exchange_gather_hier_matches_jax(port, name):
    H, _, (feats, ids, mask, bh, bd, lossless, dtype) = CASES[name]
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[dtype]
    jrows, juns = _jax_exchange(H, feats, ids, mask, bh, bd, lossless, jdtype)
    D = WORLD // H
    Bh = bh if bh is not None else tfs.request_budget(L, H)
    Bd = bd if bd is not None else H * Bh
    rounds = _hier_rounds(ids, mask, H, Bh, Bd) if lossless else 0
    res = _ranks(port, name)
    for r, (rows, unserved, counts) in enumerate(res):
        np.testing.assert_array_equal(rows, _split(jrows)[r])
        assert unserved == int(juns[r])
        assert counts["world"]["host_syncs"] == counts["world"]["all_reduce"] == rounds
        n_stage = rounds if lossless else 1
        assert counts["host"]["all_to_all"] == counts["data"]["all_to_all"] == 2 * n_stage
        assert counts["world"]["all_to_all"] == 0 and counts["data"]["host_syncs"] == 0
    got = np.concatenate([x[0] for x in res])
    if lossless and name.startswith("ex_skew"):  # every row true, the skew's rounds
        assert rounds > 1
        np.testing.assert_array_equal(got, feats[ids])
    if name.startswith("ex_lossy"):
        assert sum(u for _, u, _ in res) > 0
    if name.startswith("ex_out_of_range"):
        assert all(u == 2 for _, u, _ in res)
        for rows, _, _ in res:
            np.testing.assert_array_equal(rows[0], feats[5])
            np.testing.assert_array_equal(rows[3], feats[SS + 1])
            assert (rows[1:3] == 0).all()


def test_skew_rounds_follow_the_host_budget(port):
    """All 4 x 48 ids in shard 0, a host budget of 5: ceil(48 / 5) rounds
    on every mesh, as the skew implies (stage 2's default never drops)."""
    for H in HOSTS:
        for _, _, counts in _ranks(port, f"ex_skew_shard0_{H}"):
            assert counts["world"]["host_syncs"] == -(-L // 5)


@pytest.mark.parametrize("H", HOSTS)
def test_hierarchical_equals_flat(port, H):
    _, _, (feats, ids, mask) = CASES[f"hier_vs_flat_{H}"]
    want = np.where(mask[:, None], feats[np.where(mask, ids, 0)], 0)
    res = _ranks(port, f"hier_vs_flat_{H}")
    for r, (rh, uh, rf, uf, rx, ux) in enumerate(res):
        np.testing.assert_array_equal(rh, rf)
        np.testing.assert_array_equal(rh, rx)
        np.testing.assert_array_equal(rh, _split(want)[r])
        assert uh == uf == ux == 0


STORE_NAMES = [f"st_{k}_{H}" for H in HOSTS for k in ("plain", "hot", "peer_corrupt", "quant_peer")]


@pytest.mark.parametrize("name", STORE_NAMES)
def test_hierarchical_store_fetch_local_matches_jax(port, name):
    """``fetch_local`` of the hierarchical store equals JAX's.  JAX's
    hierarchical store cannot build a peer-hot tier on one host
    (``build_union_tables(num_hosts=1)`` returns the flat table, which it
    then shards over 'host' as if [H, U]); there the reference is JAX's
    flat store on ``make_mesh(4)``, whose exchange and peer-hot tier span
    the same four ranks and serve the same rows."""
    H, _, (feats, hot, peer_hot, quantize, corrupt, ids, mask, budget) = CASES[name]
    flat_ref = peer_hot and H == 1
    jmesh, ax = (jmake_mesh(WORLD), "data") if flat_ref else (_jmesh(H), AX)
    store = jfs.ShardedFeatureStore(feats, jmesh, axis_name=ax, hot_ids=hot, peer_hot=peer_hot, quantize=quantize,
                                    hierarchical=not flat_ref)
    if corrupt is not None:
        padded = np.zeros((SS * WORLD, F), np.float32)
        padded[:N] = corrupt
        store.features = jax.device_put(padded, NamedSharding(jmesh, P(ax, None)))

    def body(a, i, m):
        rows, uns = store.fetch_local(a, i, m, budget=budget)
        return rows, store.dequantize(rows), uns[None]

    jrows, jdeq, juns = _smap(jmesh, body, (store.shard_specs(), P(ax), P(ax)), (P(ax),) * 3,
                              store.shard_args(), jnp.asarray(ids), jnp.asarray(mask))
    res = _ranks(port, name)
    for r, (rows, deq, unserved, counts) in enumerate(res):
        np.testing.assert_array_equal(rows, _split(jrows)[r])
        np.testing.assert_array_equal(deq, _split(jdeq)[r])
        assert unserved == int(np.asarray(juns)[r]) == 0
        if peer_hot:  # the peer-hot rounds and their read-backs ride the data sub-mesh only
            assert counts["data"]["host_syncs"] >= 1 and counts["host"]["host_syncs"] == 0
    got = np.concatenate([x[1] for x in res])
    want = np.where(mask[:, None], feats[np.where(mask, ids, 0)], 0)
    if name.startswith("st_quant"):
        rel = np.abs(got - want).max(1) / np.maximum(np.abs(want).max(1), 1e-9)
        assert rel[mask].max() < 0.01
    elif not name.startswith("st_peer_corrupt"):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H", HOSTS)
def test_peer_hot_stays_inside_a_host(port, H):
    """JAX's base-corruption proof (``tests/test_parallel.py:387-458``):
    rows hot on a rank of the requester's host come back true, rows hot
    only on another host come back as the base's lie, cold rows true."""
    _, _, (feats, hot, _, _, _, ids, mask, _) = CASES[f"st_peer_corrupt_{H}"]
    D = WORLD // H
    saw_peer = saw_cross = False
    for r, (rows, _, _, _) in enumerate(_ranks(port, f"st_peer_corrupt_{H}")):
        mine = _split(ids)[r]
        h = r // D
        host_hot = np.isin(mine, hot[h * D : (h + 1) * D].reshape(-1))
        local_hot = np.isin(mine, hot[r])
        saw_peer |= bool((host_hot & ~local_hot).any())
        np.testing.assert_array_equal(rows[host_hot], feats[mine[host_hot]])
        cross_only = np.isin(mine, hot.reshape(-1)) & ~host_hot
        saw_cross |= bool(cross_only.any())
        assert (rows[cross_only] == -777.0).all()
        cold = ~np.isin(mine, hot.reshape(-1))
        np.testing.assert_array_equal(rows[cold], feats[mine[cold]])
    assert saw_peer == (D > 1) and saw_cross == (H > 1)


@pytest.mark.parametrize("H", HOSTS)
def test_hierarchical_store_fetch_matches_jax(port, H):
    _, _, (feats, ids, mask, slack) = CASES[f"fetch_tight_{H}"]
    store = jfs.ShardedFeatureStore(feats, _jmesh(H), axis_name=AX, budget_slack=slack, hierarchical=True)
    jrows, juns = jax.jit(store.fetch)(jnp.asarray(ids), jnp.asarray(mask))
    res = _ranks(port, f"fetch_tight_{H}")
    np.testing.assert_array_equal(np.concatenate([x[0] for x in res]), np.asarray(jrows))
    assert all(u == int(juns) == 0 for _, u, _ in res)
    assert all(b == store.request_budget_for(L) == tfs.request_budget(L, H, slack) for *_, b in res)
    np.testing.assert_array_equal(np.asarray(jrows), feats[ids])


def test_axis_names_and_shapes_are_checked():
    flat = tmesh.Mesh(rank=0, size=4, device=torch.device("cpu"))
    two = tmesh.Mesh(rank=3, size=4, device=torch.device("cpu"), shape=(2, 2))
    assert tmesh.check_axis(flat, "data") == ("data", False)
    assert tmesh.check_axis(two, ["host", "data"]) == (AX, True)
    assert tmesh.axis_size(two, "host") == 2 and tmesh.axis_size(two, AX) == 4 and tmesh.axis_size(flat, "data") == 4
    assert flat.axis("data") is flat and two.axis(AX) is two
    for mesh, ax in ((flat, AX), (two, "data"), (flat, "model")):
        with pytest.raises(ValueError):
            tmesh.check_axis(mesh, ax)
    with pytest.raises(ValueError, match="no process groups"):
        two.axis("host")
    with pytest.raises(ValueError):
        tmesh.axis_size(flat, "host")
    with pytest.raises(ValueError):
        tmesh.Mesh(rank=0, size=4, device=torch.device("cpu"), shape=(3, 2))
    with pytest.raises(ValueError, match="hierarchical"):
        tfs.ShardedFeatureStore(np.zeros((8, 2), np.float32), flat, hierarchical=True)
