"""The port's sharded graph and owner-side sampler against the JAX
package's, world 2.

The JAX side runs in this process on ``make_mesh(2)``; the port's in one
spawned world of two gloo ranks (every case in that one world, each case
its own test).  Sampling is held bit for bit on injected keys: each rank
gets the keys JAX derives there, ``fold_in(key, rank)`` for the owner's
``[n * budget]`` request table and ``fold_in(fold_in(key, 1), rank)`` for
its hot tier, in the form the port's ``sample_neighbors`` takes.  The
request table's layout is JAX's, slot for slot, so a tight budget's spill
rounds give JAX's samples too.  Weighted graphs take the alias sampler on
both sides (JAX with ``window=None``).
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dist_gnn_tpu.graph import INVALID_ID, HostGraph as JHostGraph
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.parallel import feature_store as jfs
from dist_gnn_tpu.parallel.graph_dist import ShardedGraph as JShardedGraph
from dist_gnn_tpu.parallel.graph_dist import sample_neighbors_cached as jcached
from dist_gnn_tpu.parallel.graph_dist import sample_neighbors_sharded as jsharded
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu_torch.graph import HostGraph as THostGraph
from dist_gnn_tpu_torch.parallel import graph_dist as tgd
from dist_gnn_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
INVALID = int(INVALID_ID)
WORLD = 2
N = 600


def _graph(weighted: bool, seed: int = 3):
    """A random multigraph of 600 nodes with a hub row and empty rows; its
    weights |N(0,1)| with some zeros."""
    rng = np.random.default_rng(seed)
    E = 5000
    dst = np.concatenate([rng.integers(0, N - 20, E), np.full(300, 7)])  # node 7 a hub; the last 20 rows empty
    src = rng.integers(0, N, dst.shape[0])
    hg = JHostGraph.from_coo(src.astype(np.int32), dst.astype(np.int32), N)
    probs = None
    if weighted:
        probs = np.abs(rng.standard_normal(hg.num_edges)).astype(np.float32)
        probs[rng.random(hg.num_edges) < 0.1] = 0.0
    return np.asarray(hg.indptr), np.asarray(hg.indices), probs


def _hot(seed=4, C=60):
    rng = np.random.default_rng(seed)
    hot = np.stack([rng.choice(N, C, replace=False).astype(np.int32) for _ in range(WORLD)])
    hot[0, :3] = [7, 590, 2]  # the hub and an empty row are hot on rank 0
    hot[1, -10:] = INVALID  # a padded tail
    return hot


def _jhg(g):
    return JHostGraph(indptr=g[0], indices=g[1], probs=g[2])


def _thg(g):
    return THostGraph(indptr=g[0], indices=g[1], probs=g[2])


# ---- the port's cases ---------------------------------------------------------


def _np(t):
    return None if t is None else t.cpu().numpy()


def _case_build(mesh, g, hot):
    sg = tgd.ShardedGraph.build(_thg(g), mesh, hot_ids=hot)
    out = {name: _np(getattr(sg, name)) for name in (
        "indptr", "indices", "probs", "alias_prob", "alias_idx", "hot_sorted", "hot_indptr", "hot_indices",
        "hot_probs", "hot_alias_prob", "hot_alias_idx")}
    out.update(shard_size=sg.shard_size, max_degree=sg.max_degree, hot_max_degree=sg.hot_max_degree)
    struct = sg.local_cached_structure_tensors()
    out["getter_structure"] = None if struct is None else tuple(_np(t) for t in struct)
    out["getter_routing"] = _np(sg.local_cached_routing_tensors())
    return out


def _mine(mesh, a):
    L = len(a) // mesh.size
    return torch.from_numpy(np.ascontiguousarray(a[mesh.rank * L : (mesh.rank + 1) * L]))


def _to_keys(k):
    """numpy keys (or a tuple of them) of this rank, as the port takes them."""
    if isinstance(k, tuple):
        return tuple(torch.from_numpy(x) for x in k)
    return torch.from_numpy(k)


def _case_sample(mesh, g, hot, seeds, mask, k, replace, budget, keys, cached):
    sg = tgd.ShardedGraph.build(_thg(g), mesh, hot_ids=hot)
    syncs = mesh.counts["host_syncs"]
    key = keys[mesh.rank]
    if cached:
        key = (_to_keys(key[0]), _to_keys(key[1]))
        nb, ovf = tgd.sample_neighbors_cached(sg, _mine(mesh, seeds), _mine(mesh, mask), k, replace, key, budget)
    else:
        nb, ovf = tgd.sample_neighbors_sharded(sg, _mine(mesh, seeds), _mine(mesh, mask), k, replace,
                                               _to_keys(key), budget)
    return nb.ids.numpy(), nb.mask.numpy(), int(ovf), mesh.counts["host_syncs"] - syncs


def _case_generator(mesh, g, hot, seeds, k):
    sg = tgd.ShardedGraph.build(_thg(g), mesh, hot_ids=hot)
    gen = torch.Generator().manual_seed(mesh.rank)
    s = _mine(mesh, seeds)
    nb, ovf = tgd.sample_neighbors_cached(sg, s, s != INVALID, k, False, gen, budget=3)
    return nb.ids.numpy(), nb.mask.numpy(), int(ovf)


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


# ---- cases and their JAX keys -------------------------------------------------

L = 48  # seeds per rank


def _seeds(seed, skew=False):
    rng = np.random.default_rng(seed)
    hi = tgd.shard_rows(N, WORLD) if skew else N
    s = rng.integers(0, hi, WORLD * L).astype(np.int32)
    s[:4] = [7, 7, 595, 2]  # the hub twice, an empty row, a hot row
    mask = rng.random(WORLD * L) < 0.9
    mask[:4] = True
    return np.where(mask, s, INVALID).astype(np.int32), mask


def _np_keys(x):
    return np.asarray(x).astype(np.int64)


def _sampler_keys(key, B, k, replace, weighted):
    """What one JAX ``sample_neighbors`` call on B seeds draws from ``key``
    (exact path): uniform ``row_key [B]`` / ``bits [B, k]``; alias
    ``bits [2, B, k]``, or ``(bits [2, B, 4k], gumbel [B, 2k])``."""
    if not weighted:
        return _np_keys(jprng.random_keys(key, (B, k) if replace else (B,)))
    if replace:
        return _np_keys(jprng.random_keys(key, (2, B, k)))
    return (_np_keys(jprng.random_keys(key, (2, B, 4 * k))),
            _np_keys(jprng.random_keys(jax.random.fold_in(key, 1), (B, 2 * k))))


def _rank_keys(jkey, k, replace, weighted, budget, cached):
    Pb = budget if budget is not None else jfs.request_budget(L, WORLD)
    out = []
    for r in range(WORLD):
        owner = _sampler_keys(jax.random.fold_in(jkey, r), WORLD * Pb, k, replace, weighted)
        if cached:
            hot_key = jax.random.fold_in(jax.random.fold_in(jkey, 1), r)
            out.append((_sampler_keys(hot_key, L, k, replace, weighted), owner))
        else:
            out.append(owner)
    return out


SAMPLE_CASES = {
    # name: (weighted, hot, skew, k, replace, budget, cached, key)
    "uniform": (False, False, False, 3, False, None, False, 7),
    "uniform_replace": (False, False, False, 3, True, None, False, 8),
    "uniform_skew_tight": (False, False, True, 4, False, 4, False, 9),
    "weighted": (True, False, False, 3, False, None, False, 10),
    "weighted_replace": (True, False, False, 2, True, None, False, 11),
    "weighted_skew_tight": (True, False, True, 5, False, 3, False, 12),
    "cached_uniform": (False, True, False, 3, False, None, True, 13),
    "cached_uniform_tight": (False, True, True, 3, False, 5, True, 14),
    "cached_weighted": (True, True, False, 4, False, None, True, 15),
}


def _cases(with_keys: bool):
    g_u, g_w = _graph(False), _graph(True)
    hot = _hot()
    c = {
        "build_uniform": (_case_build, (g_u, None)),
        "build_uniform_hot": (_case_build, (g_u, hot)),
        "build_weighted_hot": (_case_build, (g_w, hot)),
    }
    for i, (name, (weighted, use_hot, skew, k, replace, budget, cached, seed)) in enumerate(SAMPLE_CASES.items()):
        seeds, mask = _seeds(100 + i, skew)
        keys = _rank_keys(jax.random.key(seed), k, replace, weighted, budget, cached) if with_keys else None
        c[name] = (_case_sample, (g_w if weighted else g_u, hot if use_hot else None, seeds, mask, k, replace,
                                  budget, keys, cached))
    seeds, _ = _seeds(200)
    c["generator_true_neighbours"] = (_case_generator, (g_u, hot, seeds, 4))
    return c


@pytest.fixture(scope="module")
def cases():
    return _cases(with_keys=True)


@pytest.fixture(scope="module")
def port(cases):
    return tmesh.launch(_run_cases, WORLD, args=(cases,), device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(WORLD)


def _ranks(port, name):
    out = []
    for r in range(WORLD):
        status, payload = port[r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


def _prefix_equal(got, want, name):
    """The port's unpadded array equals the JAX shard's prefix; the rest of
    the JAX shard is padding (zeros)."""
    want = np.asarray(want)
    assert got.shape[0] <= want.shape[0], name
    np.testing.assert_array_equal(got, want[: got.shape[0]], err_msg=name)
    assert not want[got.shape[0]:].any(), name


@pytest.mark.parametrize("name", ["build_uniform", "build_uniform_hot", "build_weighted_hot"])
def test_sharded_graph_build_matches_jax(port, cases, jmesh, name):
    _, (g, hot) = cases[name]
    jsg = JShardedGraph.build(_jhg(g), jmesh, hot_ids=hot)
    for r, got in enumerate(_ranks(port, name)):
        assert got["shard_size"] == jsg.shard_size and got["max_degree"] == jsg.max_degree
        np.testing.assert_array_equal(got["indptr"], np.asarray(jsg.indptr)[r])
        for field in ("indices", "probs", "alias_prob", "alias_idx"):
            want = getattr(jsg, field)
            if want is None:
                assert got[field] is None, field
            else:
                _prefix_equal(got[field], want[r], field)
        if hot is None:
            assert got["hot_sorted"] is None and got["getter_structure"] is None and got["getter_routing"] is None
            continue
        assert got["hot_max_degree"] == jsg.hot_max_degree
        np.testing.assert_array_equal(got["hot_sorted"], np.asarray(jsg.hot_sorted)[r])
        np.testing.assert_array_equal(got["hot_indptr"], np.asarray(jsg.hot_indptr)[r])
        for field in ("hot_indices", "hot_probs", "hot_alias_prob", "hot_alias_idx"):
            want = getattr(jsg, field)
            if want is None:
                assert got[field] is None, field
            else:
                _prefix_equal(got[field], want[r], field)
        # the introspection getters, rank r's against JAX's chip r
        j_struct = jsg.local_cached_structure_tensors(r)
        for a, b in zip(got["getter_structure"], j_struct):
            if b is None:
                assert a is None
            else:
                _prefix_equal(a, b, "getter_structure")
        np.testing.assert_array_equal(got["getter_routing"], np.asarray(jsg.local_cached_routing_tensors(r)))


@pytest.mark.parametrize("name", list(SAMPLE_CASES))
def test_owner_side_sampling_matches_jax(port, cases, jmesh, name):
    weighted, use_hot, skew, k, replace, budget, cached, seed = SAMPLE_CASES[name]
    _, (g, hot, seeds, mask, *_rest) = cases[name]
    jsg = JShardedGraph.build(_jhg(g), jmesh, hot_ids=hot)
    key = jax.random.key(seed)

    def body(blks, s, m):
        if cached:
            nb, ovf = jcached(jsg, blks, s, m, k, replace, key, budget=budget)
        else:
            ip, ix, pr, _, alias = jsg.unpack(blks)
            nb, ovf = jsharded(jsg, ip, ix, pr, s, m, k, replace, key, budget=budget, alias_blk=alias)
        return nb.ids, jnp.broadcast_to(nb.mask, nb.ids.shape), ovf[None]

    jids, jmask, jovf = jax.jit(jax.shard_map(
        body, mesh=jmesh, in_specs=(jsg.shard_specs(), P("data"), P("data")), out_specs=(P("data"),) * 3,
        check_vma=False,
    ))(jsg.shard_args(), jnp.asarray(seeds), jnp.asarray(mask))
    res = _ranks(port, name)
    for r, (ids, msk, ovf, rounds) in enumerate(res):
        np.testing.assert_array_equal(msk, np.asarray(jmask)[r * L : (r + 1) * L], err_msg=f"rank {r} mask")
        np.testing.assert_array_equal(np.where(msk, ids, INVALID),
                                      np.asarray(jids)[r * L : (r + 1) * L], err_msg=f"rank {r} ids")
        assert ovf == int(np.asarray(jovf)[r])
        assert rounds >= 1
    # every seed served: min(deg, k) neighbours without replacement
    ids = np.concatenate([x[0] for x in res])
    msk = np.concatenate([x[1] for x in res])
    ip = g[0].astype(np.int64)
    deg = np.where(mask, ip[np.where(mask, seeds, 0) + 1] - ip[np.where(mask, seeds, 0)], 0)
    if not replace and not weighted:
        np.testing.assert_array_equal(msk.sum(1), np.minimum(deg, k))
    if skew:  # all seeds owned by rank 0, over a budget far below their count
        Pb = budget
        worst = max(int((_m & (_s < tgd.shard_rows(N, WORLD))).sum()) for _s, _m in
                    zip(np.split(seeds, WORLD), np.split(mask, WORLD)))
        assert res[0][3] > 1 and res[0][3] <= -(-worst // Pb) + 1
    assert (ids[msk] != INVALID).all() and (ids[~msk] == INVALID).all()


def test_generator_keys_sample_true_neighbours(port, cases):
    _, (g, hot, seeds, k) = cases["generator_true_neighbours"]
    ip, ix = g[0].astype(np.int64), g[1]
    res = _ranks(port, "generator_true_neighbours")
    ids = np.concatenate([x[0] for x in res])
    msk = np.concatenate([x[1] for x in res])
    assert all(x[2] == 0 for x in res)
    for i, s in enumerate(seeds):
        if s == INVALID:
            assert not msk[i].any()
            continue
        row = ix[ip[s] : ip[s + 1]]
        assert msk[i].sum() == min(len(row), k)
        assert np.isin(ids[i][msk[i]], row).all()
