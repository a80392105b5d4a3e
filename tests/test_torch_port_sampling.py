"""The port's PRNG, sampler, relabel and host data against the JAX package.

Same inputs, made with numpy from a seed, go through both packages; JAX's
threefry keys are injected into the port, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.dataloading.seeds import SeedGenerator as JSeedGenerator
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.ops import relabel as jrelabel
from dist_gnn_tpu.ops import sampling as jsampling
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.dataloading import preprocess as tpre
from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator as TSeedGenerator
from dist_gnn_tpu_torch.ops import prng as tprng
from dist_gnn_tpu_torch.ops import relabel as trelabel
from dist_gnn_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
INVALID = int(jgraph.INVALID_ID)


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    """numpy (uint32 included) -> torch, uint32 widened to int64."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


def _keys(key, shape):
    return _t(np.asarray(jprng.random_keys(key, shape)))


def _graphs(seed=0, n=300, e=2400, n_isolated=40):
    """The same CSC graph for both packages; the last ``n_isolated`` nodes
    have no in-edges, and node 0 is a hub."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - n_isolated, e)
    dst[: e // 10] = 0
    jhg = jgraph.HostGraph.from_coo(src, dst, n)
    thg = tgraph.HostGraph.from_coo(src, dst, n)
    return jhg, thg


# ---- (a) prng -------------------------------------------------------------


def test_mix32_hash_combine_uniform_bits_identical():
    x = _u32(50_000, 0)
    y = _u32(50_000, 1)
    np.testing.assert_array_equal(
        np.asarray(jprng.mix32(jnp.asarray(x))).astype(np.int64),
        tprng.mix32(_t(x)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jprng.hash_combine(jnp.asarray(x), jnp.asarray(y))).astype(np.int64),
        tprng.hash_combine(_t(x), _t(y)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jprng.bits_to_uniform(jnp.asarray(x))),
        tprng.bits_to_uniform(_t(x)).numpy(),
    )


DOMAINS = [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 1000, 1024, 65536, 2**20 + 3, 2**31 - 1]


def test_ceil_log2_identical():
    d = np.concatenate([np.arange(0, 4100), np.array(DOMAINS), _u32(1000, 2) >> 1])
    d = d.astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jprng._ceil_log2(jnp.asarray(d))).astype(np.int64),
        tprng._ceil_log2(_t(d)).numpy(),
    )


@pytest.mark.parametrize("domain", DOMAINS)
def test_feistel_permutation_identical(domain):
    R, J = 64, min(domain, 48)
    keys = _u32(R, domain % 97)
    j = np.broadcast_to(np.arange(J, dtype=np.int32), (R, J))
    d = np.full((R, 1), domain, np.int32)
    ref = np.asarray(jprng.feistel_permutation(jnp.asarray(j), jnp.asarray(d), jnp.asarray(keys)[:, None]))
    out = tprng.feistel_permutation(_t(j), _t(d), _t(keys)[:, None])
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(ref, out.numpy())
    assert (ref >= 0).all() and (ref < domain).all()


@pytest.mark.parametrize("domain", DOMAINS)
def test_uniform_mod_identical(domain):
    bits = _u32(4096, domain % 89)
    ref = np.asarray(jprng.uniform_mod(jnp.asarray(bits), jnp.asarray(np.int32(domain))))
    np.testing.assert_array_equal(ref, tprng.uniform_mod(_t(bits), domain).numpy())


# ---- (b) sample_uniform ---------------------------------------------------


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_sample_uniform_identical(replace, k):
    jhg, thg = _graphs(seed=k)
    jg, tg = jhg.to_device(), thg.to_device("cpu")
    rng = np.random.default_rng(10 + k)
    seeds = rng.integers(0, thg.num_nodes, 96).astype(np.int32)
    seeds[::7] = INVALID  # padded slots
    seeds[1::11] = thg.num_nodes - 1  # zero-degree rows
    seeds[2] = 0  # the hub
    key = jax.random.key(k)
    shape = (96, k) if replace else (96,)
    ref = jsampling.sample_uniform(jg, jnp.asarray(seeds), k=k, replace=replace, key=key)
    out = tsampling.sample_uniform(tg, torch.from_numpy(seeds), k, replace, _keys(key, shape))
    ref_mask = np.broadcast_to(np.asarray(ref.mask), (96, k))  # JAX keeps [B, 1] when replace
    np.testing.assert_array_equal(np.asarray(ref.ids), out.ids.numpy())
    np.testing.assert_array_equal(ref_mask, out.mask.numpy())
    assert out.ids.dtype == torch.int32 and out.mask.shape == (96, k)
    assert not out.mask.numpy()[::7].any()
    assert not out.mask.numpy()[1::11].any()


def test_sample_neighbors_draws_from_generator_and_rejects_probs():
    _, thg = _graphs()
    tg = thg.to_device("cpu")
    seeds = torch.arange(32, dtype=torch.int32)
    a = tsampling.sample_neighbors(tg, seeds, 4, False, torch.Generator().manual_seed(3))
    b = tsampling.sample_neighbors(tg, seeds, 4, False, torch.Generator().manual_seed(3))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.mask, b.mask)
    # a weighted graph samples too (K7's plain version here), from the
    # generator or from keys of its shape; weights that are not parallel to
    # the edges, and keys of another shape, are rejected
    weighted = tgraph.HostGraph(
        thg.indptr, thg.indices, probs=np.ones(thg.num_edges, np.float32)
    ).to_device("cpu")
    c = tsampling.sample_neighbors(weighted, seeds, 4, False, torch.Generator().manual_seed(3))
    d = tsampling.sample_biased_plain(weighted, seeds, 4, False, torch.Generator().manual_seed(3))
    assert torch.equal(c.ids, d.ids) and torch.equal(c.mask, d.mask)
    with pytest.raises(ValueError):
        tsampling.sample_neighbors(weighted, seeds, 4, False, torch.zeros(31, dtype=torch.int64))
    with pytest.raises(ValueError):
        tgraph.HostGraph(thg.indptr, thg.indices, probs=np.ones(thg.num_edges - 1, np.float32))


# ---- (c) unique_and_relabel ------------------------------------------------


@pytest.mark.parametrize("S,B,k", [(8, 8, 4), (40, 40, 15), (1000, 1000, 50)])
def test_unique_and_relabel_matches_both_jax_variants(S, B, k):
    rng = np.random.default_rng(S)
    N = 4 * (S + B * k)
    seeds = rng.choice(N, S, replace=False).astype(np.int32)
    seeds[-(S // 4) :] = INVALID  # padded tail
    ids = rng.integers(0, N // 8, (B, k)).astype(np.int32)  # many duplicates
    ids[:, 0] = seeds[rng.integers(0, S - S // 4, B)]  # neighbours equal to seeds
    mask = rng.random((B, k)) < 0.8
    mask[0] = False  # an all-masked row
    ids = np.where(mask, ids, INVALID).astype(np.int32)
    out = trelabel.unique_and_relabel(torch.from_numpy(seeds), torch.from_numpy(ids), torch.from_numpy(mask))
    for ref in (
        jrelabel.unique_and_relabel(jnp.asarray(seeds), jnp.asarray(ids), jnp.asarray(mask)),
        jrelabel.unique_and_relabel_dense(jnp.asarray(seeds), jnp.asarray(ids), jnp.asarray(mask), N),
    ):
        for name in ref._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, name)), getattr(out, name).numpy(), err_msg=name
            )
    assert out.frontier.dtype == torch.int32 and out.neigh_slots.dtype == torch.int32


def test_unique_and_relabel_duplicate_seeds_map_to_first():
    seeds = np.array([5, 3, 5, INVALID], np.int32)
    ids = np.array([[5, 3, 9], [9, 7, INVALID]], np.int32)
    mask = ids != INVALID
    out = trelabel.unique_and_relabel(torch.from_numpy(seeds), torch.from_numpy(ids), torch.from_numpy(mask))
    ref = jrelabel.unique_and_relabel(jnp.asarray(seeds), jnp.asarray(ids), jnp.asarray(mask))
    for name in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(out, name).numpy())
    # 5 -> seed slot 0 (its first copy), new ids 7 < 9 -> slots 4, 5
    assert out.neigh_slots.tolist() == [[0, 1, 5], [5, 4, 0]]


# ---- (d) sample_blocks -----------------------------------------------------


def _assert_blocks_equal(jblocks, tblocks):
    assert len(jblocks) == len(tblocks)
    for jb, tb in zip(jblocks, tblocks):
        for name in jb._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(jb, name)), getattr(tb, name).numpy(), err_msg=name
            )


def jax_hop_keys(key, jblocks, fan_out):
    """The per-hop row keys the JAX sampler drew (replace=False)."""
    keys = jax.random.split(key, len(fan_out))
    return [_keys(keys[i], (b.num_dst,)) for i, b in enumerate(jblocks)]


@pytest.mark.parametrize("dedup_last", [True, False])
@pytest.mark.parametrize("frontier_caps", [None, (40, 90, 250)])
def test_sample_blocks_identical(dedup_last, frontier_caps):
    jhg, thg = _graphs(seed=4, n=500, e=4000)
    fan_out = (4, 3, 2)
    rng = np.random.default_rng(5)
    seeds = rng.choice(400, 16, replace=False).astype(np.int32)
    seeds[-3:] = INVALID
    mask = seeds != INVALID
    key = jax.random.key(7)
    jblocks, jstats = jsampler.sample_blocks(
        jhg.to_device(), jnp.asarray(seeds), jnp.asarray(mask), fan_out, False, key,
        frontier_caps=frontier_caps, dedup_last=dedup_last,
    )
    tblocks, tstats = tsampler.sample_blocks(
        thg.to_device("cpu"), torch.from_numpy(seeds), torch.from_numpy(mask), fan_out,
        False, jax_hop_keys(key, jblocks, fan_out),
        frontier_caps=frontier_caps, dedup_last=dedup_last,
    )
    _assert_blocks_equal(jblocks, tblocks)
    for name in ("sampler_overflow", "frontier_overflow"):
        assert int(jstats[name]) == int(tstats[name]), name
    if frontier_caps is not None:
        assert int(tstats["frontier_overflow"]) > 0


def test_neighbor_sampler_replace_true_runs():
    """JAX's sample_blocks cannot run replace=True (its uniform sampler
    returns a [B, 1] mask that the relabel cannot broadcast); the port's
    [B, k] mask chains through every hop."""
    _, thg = _graphs()
    s = tsampler.NeighborSampler(thg.to_device("cpu"), (3, 2), replace=True)
    seeds = torch.arange(8, dtype=torch.int32)
    blocks, _ = s.sample(seeds, torch.ones(8, dtype=torch.bool), torch.Generator().manual_seed(0))
    assert [b.num_dst for b in blocks] == [8, 24]
    for b in blocks:
        f = b.frontier.long()
        assert torch.equal(f[: b.num_dst], b.seeds.long())
        nb = f[b.neigh_slots.long()]
        assert (nb[b.neigh_mask] != INVALID).all()


def test_layer_capacities():
    assert tsampler.layer_capacities(512, (15, 10, 5)) == jsampler.layer_capacities(512, (15, 10, 5))
    assert tsampler.layer_capacities(512, (15, 10, 5))[-1] == 540_672


# ---- (e) host graph, synthetic data, seeds --------------------------------


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("with_probs", [False, True])
def test_from_coo_identical(symmetrize, with_probs):
    rng = np.random.default_rng(11)
    n, e = 97, 1500
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 5, e)
    probs = rng.random(e).astype(np.float32) if with_probs else None
    j = jgraph.HostGraph.from_coo(src, dst, n, probs=probs, symmetrize=symmetrize)
    t = tgraph.HostGraph.from_coo(src, dst, n, probs=probs, symmetrize=symmetrize)
    for name in ("indptr", "indices", "probs"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.degrees, t.degrees)
    assert j.max_degree == t.max_degree and j.num_edges == t.num_edges


def test_from_coo_rejects_out_of_range_dst():
    with pytest.raises(ValueError):
        tgraph.HostGraph.from_coo(np.array([0, 1]), np.array([0, 5]), 3)


def test_make_synthetic_dataset_identical():
    kw = dict(num_nodes=2000, avg_degree=6, feature_dim=12, num_classes=5, train_frac=0.2, seed=3, with_probs=True)
    ja, jm = jpre.make_synthetic_dataset(**kw)
    ta, tm = tpre.make_synthetic_dataset(**kw)
    assert jm == tm and set(ja) == set(ta)
    for name in ja:
        assert ja[name].dtype == ta[name].dtype, name
        np.testing.assert_array_equal(ja[name], ta[name], err_msg=name)
    np.testing.assert_array_equal(jpre.add_random_probs(77, 5), tpre.add_random_probs(77, 5))


@pytest.mark.parametrize("drop_last", [False, True])
def test_seed_generator_unshuffled_identical(drop_last):
    data = np.random.default_rng(0).permutation(103).astype(np.int32)
    jb = list(JSeedGenerator(data, 16, drop_last=drop_last).epoch(jax.random.key(0)))
    tgen = TSeedGenerator(data, 16, drop_last=drop_last, device="cpu")
    tb = list(tgen.epoch())
    assert len(jb) == len(tb) == len(tgen)
    for (js, jm), (ts, tm) in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def test_seed_generator_shuffle_is_a_seeded_permutation():
    data = np.arange(50, dtype=np.int32)
    gen = TSeedGenerator(data, 8, shuffle=True, device="cpu")
    a = torch.cat([s for s, _ in gen.epoch(torch.Generator().manual_seed(1))])
    b = torch.cat([s for s, _ in gen.epoch(torch.Generator().manual_seed(1))])
    assert torch.equal(a, b)
    assert sorted(a[a != INVALID].tolist()) == list(range(50))
    with pytest.raises(ValueError):
        next(gen.epoch())
