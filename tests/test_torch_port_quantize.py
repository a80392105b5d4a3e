"""Int8 row packing (``ops/quantize.py``), the int8 cache plan and the
quantized sharded store, against the JAX package.

Packing and unpacking are exact (the same f32 arithmetic, the scale's
bytes carried bit for bit).  The int8 plan prices a hot row at ``F + 4``
bytes and must pick JAX's hot ids.  The quantized store runs in one
spawned world of two gloo ranks against JAX's store on ``make_mesh(2)``:
packed rows equal exactly, dequantized rows within int8's 1% of the
features.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu.cache import builder as jbuilder
from dist_gnn_tpu.dataloading.preprocess import make_synthetic_dataset
from dist_gnn_tpu.ops import quantize as jq
from dist_gnn_tpu.parallel import feature_store as jfs
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch.cache import builder as tbuilder
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.ops import quantize as tq
from dist_gnn_tpu_torch.parallel import feature_store as tfs
from dist_gnn_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
INVALID = int(jgraph.INVALID_ID)
WORLD = 2


def _feats(N, F, seed, spread=True):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((N, F)).astype(np.float32)
    if spread:
        f *= rng.uniform(0.5, 5, (N, 1)).astype(np.float32)
    return f


@pytest.mark.parametrize("N,F", [(1, 1), (37, 12), (500, 100), (0, 4)])
def test_quantize_pack_is_jax_s_bit_for_bit(N, F):
    f = _feats(N, F, N + F)
    if N > 2:
        f[0] = 0.0  # an all-zero row: the 1e-12 floor of the scale
        f[1, 0] = 1e30  # a huge row
    got, want = tq.quantize_pack(f), jq.quantize_pack(f)
    assert got.dtype == want.dtype == np.int8 and got.shape == (N, F + 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequantize_unpack_is_exact(out_dtype):
    packed = tq.quantize_pack(_feats(64, 12, 3)).reshape(2, 32, 16)  # a batch dim too
    jout = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out_dtype]
    want = np.asarray(jq.dequantize_unpack(jnp.asarray(packed), jout).astype(jnp.float32))
    got = tq.dequantize_unpack(torch.from_numpy(packed), out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 32, 12)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_packed_rows_ride_k1_unchanged():
    packed = torch.from_numpy(tq.quantize_pack(_feats(50, 9, 4)))
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 50, 77).astype(np.int32))
    rows = tgather.gather_rows(packed, idx)
    assert torch.equal(rows, packed[idx.long()])
    assert torch.equal(tq.dequantize_unpack(rows), tq.dequantize_unpack(packed)[idx.long()])


@pytest.fixture(scope="module")
def plan_data():
    arrays, meta = make_synthetic_dataset(
        num_nodes=4000, avg_degree=10, feature_dim=64, num_classes=8, train_frac=0.3, seed=0
    )
    parts = np.array_split(arrays["train_idx"], WORLD)
    return arrays, parts


@pytest.mark.parametrize("policy", ["selfish", "selfless", "auto"])
def test_int8_plan_matches_jax(plan_data, policy):
    arrays, parts = plan_data
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    thg = tgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    cap = 300 * (64 * 4 + 16)
    jm, js, jf = jbuilder.build_cache_plan(jhg, 64, parts, (5, 5), cap, policy=policy, hot_dtype="int8")
    tm, ts, tf = tbuilder.build_cache_plan(thg, 64, parts, (5, 5), cap, policy=policy, hot_dtype=torch.int8,
                                           device="cpu")
    assert tm == jm
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tf, jf)
    # equal bytes: int8 admits about (4F)/(F+4) = 3.8x the f32 rows
    _, _, f32 = tbuilder.build_cache_plan(thg, 64, parts, (5, 5), cap, policy=policy, device="cpu")
    assert np.sum(tf != INVALID) >= 2.5 * np.sum(f32 != INVALID)


# ---- the quantized sharded store, world 2 -------------------------------------


def _mine(mesh, a):
    L = len(a) // mesh.size
    return torch.from_numpy(np.ascontiguousarray(a[mesh.rank * L : (mesh.rank + 1) * L]))


def _case_store(mesh, feats, hot, quantize, ids, budget):
    store = tfs.ShardedFeatureStore(feats, mesh, hot_ids=hot, quantize=quantize)
    rows, unserved = store.fetch_local(_mine(mesh, ids), torch.ones(len(ids) // mesh.size, dtype=torch.bool),
                                       budget=budget)
    return (rows.numpy(), store.dequantize(rows).numpy(), int(unserved), store.hot_hit_rate(_mine(mesh, ids).numpy()),
            store.feature_dim, tuple(store.features.shape))


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


def _cases():
    rng = np.random.default_rng(10)
    N, F = 700, 12
    feats = _feats(N, F, 10)
    hot = np.stack([rng.choice(N, 50, replace=False).astype(np.int32) for _ in range(WORLD)])
    ids = rng.integers(0, N, WORLD * 48).astype(np.int32)
    return {
        "hot_int8": (_case_store, (feats, hot, True, ids, 48)),
        "base_int8_tight": (_case_store, (feats, None, True, ids, 5)),
        "hot_f32": (_case_store, (feats, hot, False, ids, 48)),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    return tmesh.launch(_run_cases, WORLD, args=(CASES,), device="cpu", timeout_s=240)


def _ranks(port, name):
    out = []
    for r in range(WORLD):
        status, payload = port[r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


@pytest.mark.parametrize("name", ["hot_int8", "base_int8_tight", "hot_f32"])
def test_quantized_store_matches_jax(port, name):
    _, (feats, hot, quantize, ids, budget) = CASES[name]
    jmesh = jmake_mesh(WORLD)
    store = jfs.ShardedFeatureStore(feats, jmesh, hot_ids=hot, quantize=quantize)

    def body(a, i, m):
        rows, ov = store.fetch_local(a, i, m, budget=budget)
        return rows, store.dequantize(rows), ov[None]

    jrows, jdeq, jov = jax.jit(jax.shard_map(
        body, mesh=jmesh, in_specs=(store.shard_specs(), P("data"), P("data")), out_specs=(P("data"),) * 3,
        check_vma=False,
    ))(store.shard_args(), jnp.asarray(ids), jnp.ones(len(ids), bool))
    res = _ranks(port, name)
    L = len(ids) // WORLD
    for r, (rows, deq, unserved, hit, fdim, shard_shape) in enumerate(res):
        np.testing.assert_array_equal(rows, np.asarray(jrows)[r * L : (r + 1) * L])
        np.testing.assert_array_equal(deq, np.asarray(jdeq)[r * L : (r + 1) * L])
        assert unserved == int(np.asarray(jov)[r]) == 0
        assert fdim == feats.shape[1]
        assert shard_shape == (store.shard_size, feats.shape[1] + (4 if quantize else 0))
        if hot is not None:
            assert hit == store.hot_hit_rate(ids[r * L : (r + 1) * L], chip=r)
    got = np.concatenate([x[1] for x in res])
    want = feats[ids]
    rel = np.abs(got - want).max(1) / np.maximum(np.abs(want).max(1), 1e-9)
    assert rel.max() < (0.01 if quantize else 1e-7)
