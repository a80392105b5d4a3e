"""Weighted (biased) sampling: the port against the JAX package on the same
numpy inputs and injected keys, on the CPU.

Tolerances: ``build_alias`` and ``build_csc`` bit for bit; the plain
samplers' ids and mask bit for bit on JAX's keys (the Gumbel keys'
``log`` may differ from XLA's by an ulp, which could reorder two keys
within an ulp of each other: none of these inputs has such a near-tie, and
``_near_tie_rows`` names any that would); the dispatch against JAX's
windowed sampler and the A-Res oracle statistically, each inclusion
probability within 0.03 (``tests/test_sampling.py``'s limit); 3 weighted
SAGE train steps: step-1 loss 1e-5 and gradients rtol 1e-4 / atol 1e-6
(summation order only), the three losses 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.ops import sampling as jsampling
from dist_gnn_tpu.training import Trainer as JTrainer
from dist_gnn_tpu.utils import native as jnative
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.ops import sampling as tsampling
from dist_gnn_tpu_torch.training import Trainer as TTrainer
from dist_gnn_tpu_torch.utils import native as tnative
from dist_gnn_tpu_torch.weights import sage_params_from_jax

torch.set_num_threads(1)
INVALID = int(jgraph.INVALID_ID)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(x.astype(np.int64) if x.dtype == np.uint32 else x))


def _weighted(seed, n=300, degs=(0, 1, 5, 10, 11, 20, 21, 300, 600), max_deg=60, p_zero=0.15):
    """A weighted COO: rows of the named degrees first (a hub among them),
    then random ones; a share of zero weights."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([degs, rng.integers(0, max_deg, n - len(degs))])
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, len(dst))
    w = np.abs(rng.standard_normal(len(dst))).astype(np.float32)
    w[rng.random(len(w)) < p_zero] = 0
    return src, dst, n, w, rng


def _graphs(seed, indptr_dtype=np.int32, **kw):
    src, dst, n, w, rng = _weighted(seed, **kw)
    jhg = jgraph.HostGraph.from_coo(src, dst, n, probs=w)
    thg = tgraph.HostGraph.from_coo(src, dst, n, probs=w)
    thg = tgraph.HostGraph(indptr=thg.indptr.astype(indptr_dtype), indices=thg.indices, probs=thg.probs)
    return jhg, thg, rng


def _seeds(rng, n, B, special=9):
    s = np.concatenate([np.arange(special), rng.integers(0, n, B - special)]).astype(np.int32)
    s[::11] = INVALID
    return s


def _near_tie_rows(keys_sorted, k):
    """Rows whose k-th and (k+1)-th keys lie within 2 ulp: the only rows
    where an ulp of ``log`` could reorder a pick."""
    a, b = keys_sorted[:, k - 1], keys_sorted[:, k]
    fin = np.isfinite(a) & np.isfinite(b)
    a, b = np.where(fin, a, 0), np.where(fin, b, 0)
    return np.flatnonzero(fin & (np.abs(a - b) <= 2 * np.spacing(np.abs(a).astype(np.float32))))


# ---- host arrays: build_alias, build_csc -------------------------------------


@pytest.mark.parametrize("case", ["random", "zero_rows", "leftovers", "tiny_weights"])
def test_build_alias_equals_jax_native(case):
    rng = np.random.default_rng(["random", "zero_rows", "leftovers", "tiny_weights"].index(case))
    deg = rng.integers(0, 40, 400)
    deg[:4] = [0, 1, 2, 300]
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    w = np.abs(rng.standard_normal(indptr[-1])).astype(np.float32)
    if case == "zero_rows":
        for r in range(0, 400, 7):
            w[indptr[r]:indptr[r + 1]] = 0  # rows whose weights sum to 0
        w[rng.random(len(w)) < 0.3] = 0
    elif case == "leftovers":
        # near-uniform rows: scaled weights at 1 - 1e-7 leave either stack
        # with numerical leftovers
        w = np.float32(1.0) + (rng.random(len(w)) < 0.5) * np.float32(1e-7)
    elif case == "tiny_weights":
        w = (w * np.float32(1e-30)).astype(np.float32)
    assert jnative.available()  # JAX's reference is its native build
    jp, ja = jnative.build_alias(indptr, w)
    tp, ta = tnative.build_alias(indptr, w)
    pp, pa = tnative.build_alias_plain(indptr, w)
    for p, a in ((tp, ta), (pp, pa)):
        np.testing.assert_array_equal(p.view(np.int32), jp.view(np.int32))
        np.testing.assert_array_equal(a, ja)
    # a valid table: offsets in the row, thresholds in [0, 1]
    assert ((tp >= 0) & (tp <= 1)).all()
    rows = np.repeat(np.arange(400), deg)
    assert ((ta >= 0) & (ta < deg[rows])).all()


def test_alias_tables_sample_the_weights():
    """Each edge's draw probability from the tables, (prob_j + sum of the
    (1 - prob_i) aliased to j) / deg, equals w_j / sum(w)."""
    rng = np.random.default_rng(3)
    w = np.abs(rng.standard_normal(50)).astype(np.float32)
    w[::9] = 0
    p, a = tnative.build_alias(np.array([0, 50]), w)
    got = p.astype(np.float64).copy()
    np.add.at(got, a, 1.0 - p.astype(np.float64))
    np.testing.assert_allclose(got / 50, w / w.astype(np.float64).sum(), atol=1e-6)
    assert (got[w == 0] == 0).all()


@pytest.mark.parametrize("with_probs", [False, True])
def test_build_csc_equals_jax(with_probs):
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 90, 2000), rng.integers(0, 90, 2000)
    w = rng.random(2000).astype(np.float32) if with_probs else None
    want = jnative.build_csc(dst, src, 90, w)
    for got in (tnative.build_csc(dst, src, 90, w), tnative.build_csc_plain(dst, src, 90, w)):
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    jh = jgraph.HostGraph.from_coo(src, dst, 90, probs=w, symmetrize=True)
    th = tgraph.HostGraph.from_coo(src, dst, 90, probs=w, symmetrize=True)
    np.testing.assert_array_equal(th.indptr, jh.indptr)
    np.testing.assert_array_equal(th.indices, jh.indices)
    if with_probs:
        np.testing.assert_array_equal(th.probs, jh.probs)
    with pytest.raises(ValueError):
        tnative.build_csc(np.array([0, 90]), np.array([1, 2]), 90)


def test_to_device_with_alias_carries_the_tables():
    jhg, thg, _ = _graphs(5)
    g = thg.to_device("cpu", with_alias=True)
    jp, ja = jnative.build_alias(thg.indptr, thg.probs)
    np.testing.assert_array_equal(g.alias_prob.numpy(), jp)
    np.testing.assert_array_equal(g.alias_idx.numpy(), ja)
    assert thg.to_device("cpu").alias_prob is None
    with pytest.raises(ValueError):
        tgraph.HostGraph(indptr=thg.indptr, indices=thg.indices).build_alias_tables()


# ---- the plain samplers against JAX on its keys --------------------------------


@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("replace", [False, True])
def test_sample_biased_plain_equals_jax(replace, k, indptr_dtype):
    jhg, thg, rng = _graphs(k + replace, indptr_dtype)
    seeds = _seeds(rng, thg.num_nodes, 200)
    key = jax.random.key(100 + k)
    want = jsampling.sample_biased(jhg.to_device(), jnp.asarray(seeds), k, replace, key)
    keys = _t(jprng.random_keys(key, (len(seeds), k) if replace else (len(seeds),)))
    got = tsampling.sample_biased_plain(thg.to_device("cpu"), torch.from_numpy(seeds), k, replace, keys)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.any() and (got.ids.numpy()[~got.mask.numpy()] == INVALID).all()
    # the wrapper runs the plain version on CPU tensors, and no zero-weight
    # edge is ever drawn
    again = tsampling.sample_biased(thg.to_device("cpu"), torch.from_numpy(seeds), k, replace, keys)
    assert torch.equal(again.ids, got.ids) and tsampling.sample_biased.launches == 0
    _assert_positive_weight_picks(thg, seeds, got)


def _assert_positive_weight_picks(thg, seeds, out):
    indptr = thg.indptr.astype(np.int64)
    ids, mask = out.ids.numpy(), out.mask.numpy()
    for r in np.flatnonzero(mask.any(1)):
        lo, hi = indptr[seeds[r]], indptr[seeds[r] + 1]
        nb, w = thg.indices[lo:hi], thg.probs[lo:hi]
        for v in ids[r][mask[r]]:
            assert (w[nb == v] > 0).any(), (r, v)


def test_sample_biased_keys_have_no_near_ties():
    """The keys of the no-replacement test above hold no near-tie at any k:
    the exact equality there is not luck of a tolerance."""
    jhg, thg, rng = _graphs(5)
    seeds = _seeds(rng, thg.num_nodes, 200)
    keys = _t(jprng.random_keys(jax.random.key(105), (len(seeds),)))
    g = thg.to_device("cpu")
    start, deg, valid = tsampling._row_extents(g, torch.from_numpy(seeds))
    D = int(deg.max())
    off = torch.arange(D)
    in_row = off[None, :] < deg[:, None]
    w = torch.where(in_row, g.probs[torch.clamp(start[:, None] + off, 0, g.num_edges - 1)], 0.0)
    gk = tsampling.gumbel_keys(tsampling.prng.mix32(keys[:, None] ^ tsampling.prng.mix32(off)[None, :]), w, in_row)
    ks = torch.sort(gk, dim=1, descending=True).values.numpy()
    for k in (1, 5, 10):
        assert len(_near_tie_rows(ks, k)) == 0


@pytest.mark.parametrize("k", [2, 5, 10])
@pytest.mark.parametrize("replace", [False, True])
def test_sample_biased_alias_plain_equals_jax(replace, k):
    jhg, thg, rng = _graphs(20 + k)
    seeds = _seeds(rng, thg.num_nodes, 200)
    key = jax.random.key(200 + k)
    B = len(seeds)
    want = jsampling.sample_biased_alias(jhg.to_device(with_alias=True), jnp.asarray(seeds), k, replace, key)
    if replace:
        keys = _t(jprng.random_keys(key, (2, B, k)))
    else:
        keys = (_t(jprng.random_keys(key, (2, B, 4 * k))),
                _t(jprng.random_keys(jax.random.fold_in(key, 1), (B, 2 * k))))
    g = thg.to_device("cpu", with_alias=True)
    got = tsampling.sample_biased_alias_plain(g, torch.from_numpy(seeds), k, replace, keys)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.overflow) == int(want.overflow) and got.overflow.dtype == torch.int32
    _assert_positive_weight_picks(thg, seeds, got)
    assert tsampling.sample_biased_alias.launches == 0


def _row0_graph(weights):
    d = len(weights)
    indptr = np.concatenate([[0, d], np.full(16, d)]).astype(np.int64)
    indices = (np.arange(d) + 10).astype(np.int32)
    w = np.asarray(weights, np.float32)
    return (jgraph.HostGraph(indptr=indptr, indices=indices, probs=w),
            tgraph.HostGraph(indptr=indptr, indices=indices, probs=w))


def test_alias_sparse_path_row0_not_clobbered():
    """``tests/test_sampling.py:369``: non-taken draws once overwrote row 0's
    first pick with offset 0.  Edge 0 has weight 1e-6; over 200 keys the
    port's picks equal JAX's, and offset 0 stays rare in row 0 slot 0."""
    w = np.full(10, 1.0, np.float32)
    w[0] = 1e-6
    jhg, thg = _row0_graph(w)
    jg, tg = jhg.to_device(with_alias=True), thg.to_device("cpu", with_alias=True)
    hits = 0
    for t in range(200):
        key = jax.random.key(t)
        want = jsampling.sample_biased_alias(jg, jnp.zeros((1,), jnp.int32), 2, False, key)
        keys = (_t(jprng.random_keys(key, (2, 1, 8))), _t(jprng.random_keys(jax.random.fold_in(key, 1), (1, 4))))
        got = tsampling.sample_biased_alias_plain(tg, torch.zeros(1, dtype=torch.int32), 2, False, keys)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        hits += int(got.ids[0, 0]) == 10
    assert hits <= 2, hits


@pytest.mark.parametrize("sampler", ["alias", "biased"])
def test_zero_weight_edges_never_taken_take_all(sampler):
    """``tests/test_sampling.py:789``: a row of degree <= k takes its
    positive-weight edges only."""
    indptr = np.array([0, 3], np.int64)
    indices = np.array([10, 11, 12], np.int32)
    probs = np.array([1.0, 0.0, 1.0], np.float32)
    g = tgraph.HostGraph(indptr=indptr, indices=indices, probs=probs).to_device("cpu", with_alias=True)
    gen = torch.Generator().manual_seed(0)
    for replace in (False, True):
        fn = tsampling.sample_biased_alias if sampler == "alias" else tsampling.sample_biased
        out = fn(g, torch.zeros(1, dtype=torch.int32), 5, replace, gen)
        ids, mask = out.ids[0].numpy(), out.mask[0].numpy()
        assert set(ids[mask].tolist()) == ({10, 12} if not replace else set(ids[mask].tolist()) - {11})
        assert 11 not in ids[mask].tolist()
        assert int(out.overflow) == 0


# ---- the dispatch, statistically ----------------------------------------------


def _ares_oracle(w, k, O=30000):
    rngen = np.random.default_rng(0)
    wa = np.asarray(w, np.float64)
    oracle = np.zeros(len(w))
    for _ in range(O):
        keys = rngen.random(len(w)) ** (1 / wa)
        oracle[np.argsort(-keys)[:k]] += 1
    return oracle / O


@pytest.mark.parametrize(
    "w,k,window,budget",
    [([8, 4, 2, 1, 1, 1, 1, 1, 0.5, 0.5], 2, (16, 64), (64, 16)),  # JAX's level 1
     (list(np.linspace(8, 0.5, 40)), 3, (8, 64), (4096, 64)),  # level 2
     (list(np.linspace(8, 0.5, 40)), 3, (8, 16), (4096, 4096))],  # the alias tail
    ids=["level1", "level2", "tail"],
)
def test_dispatch_matches_windowed_and_ares_oracle(w, k, window, budget):
    """Where the JAX package takes ``sample_biased_windowed`` the port's
    dispatch takes the alias sampler; both include each edge as often as
    A-Res does (``tests/test_sampling.py:576-640``)."""
    d, pad = len(w), 500
    indptr = np.concatenate([[0, d], np.linspace(d, d + pad, 16).astype(np.int64)]).astype(np.int64)
    indices = np.concatenate([np.arange(d) + 10, np.zeros(pad)]).astype(np.int32)
    probs = np.concatenate([np.asarray(w, np.float32), np.ones(pad, np.float32)])
    T = 4000
    jg = jgraph.HostGraph(indptr=indptr, indices=indices, probs=probs).to_device(with_alias=True)
    jout = jsampling.sample_biased_windowed(jg, jnp.zeros((T,), jnp.int32), k=k, key=jax.random.key(9),
                                            window=window, big_row_budget=budget)
    tg = tgraph.HostGraph(indptr=indptr, indices=indices, probs=probs).to_device("cpu", with_alias=True)
    tout = tsampling.sample_neighbors(tg, torch.zeros(T, dtype=torch.int32), k, False,
                                      torch.Generator().manual_seed(9))
    oracle = _ares_oracle(w, k)
    assert int(jout.overflow) == 0
    # the alias sampler's rare shortfall (fewer than k distinct in 4k draws)
    # is masked and counted, as JAX's own alias test allows
    assert int(tout.overflow) == int((~tout.mask).sum())
    for ids, mask in ((np.asarray(jout.ids), np.asarray(jout.mask)), (tout.ids.numpy(), tout.mask.numpy())):
        assert mask.mean() > 0.999
        for row, m in zip(ids, mask):
            assert len(set(row[m])) == m.sum() and all(10 <= x < 10 + d for x in row[m])
        incl = [(ids == 10 + i).any(axis=1).mean() for i in range(d)]
        np.testing.assert_allclose(incl, oracle, atol=0.03)


def test_dispatch_picks_the_sampler_by_the_graph(monkeypatch):
    src, dst, n, w, _ = _weighted(7)
    calls = []
    for name in ("sample_uniform", "sample_biased", "sample_biased_alias"):
        fn = getattr(tsampling, name)
        monkeypatch.setattr(tsampling, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    gen = torch.Generator().manual_seed(0)
    seeds = torch.arange(20, dtype=torch.int32)
    for hg, alias in ((tgraph.HostGraph.from_coo(src, dst, n), False),
                      (tgraph.HostGraph.from_coo(src, dst, n, probs=w), False),
                      (tgraph.HostGraph.from_coo(src, dst, n, probs=w), True)):
        tsampling.sample_neighbors(hg.to_device("cpu", with_alias=alias), seeds, 3, False, gen)
    assert calls == ["sample_uniform", "sample_biased", "sample_biased_alias"]


def test_sample_biased_replace_matches_weights():
    """With replacement both weighted samplers draw each edge in proportion
    to its weight (binomial bound as ``tests/test_sampling.py``)."""
    w = [8, 4, 1, 1, 1, 1, 0]
    jhg, thg = _row0_graph(w)
    g = thg.to_device("cpu", with_alias=True)
    T, k = 3000, 4
    for fn in (tsampling.sample_biased, tsampling.sample_biased_alias):
        out = fn(g, torch.zeros(T, dtype=torch.int32), k, True, torch.Generator().manual_seed(3))
        ids = out.ids.numpy()
        assert out.mask.all()
        for i, wi in enumerate(w):
            p = wi / 16.0
            bound = 4 * np.sqrt(max(p * (1 - p), 1e-12) / (T * k))
            assert abs((ids == 10 + i).mean() - p) < bound + 0.01, (fn.__name__, i)


# ---- sample_blocks and Trainer on a weighted graph --------------------------------


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("dedup_last", [True, False])
def test_sample_blocks_weighted_equals_jax(alias, dedup_last):
    jhg, thg, rng = _graphs(31, n=200, degs=(0, 1, 5, 12, 200), max_deg=30)
    fan_out = (4, 3)
    seeds = rng.permutation(np.arange(5, 200))[:40].astype(np.int32)
    seeds[:5] = np.arange(5)
    seeds[::9] = INVALID
    mask = seeds != INVALID
    key = jax.random.key(13)
    jblocks, jstats = jsampler.sample_blocks(jhg.to_device(with_alias=alias), jnp.asarray(seeds),
                                             jnp.asarray(mask), fan_out, False, key, dedup_last=dedup_last)
    hk = jax.random.split(key, len(fan_out))
    keys = []
    for i, (b, k) in enumerate(zip(jblocks, reversed(fan_out))):
        B = b.num_dst
        keys.append((_t(jprng.random_keys(hk[i], (2, B, 4 * k))),
                     _t(jprng.random_keys(jax.random.fold_in(hk[i], 1), (B, 2 * k)))) if alias
                    else _t(jprng.random_keys(hk[i], (B,))))
    tblocks, tstats = tsampler.sample_blocks(thg.to_device("cpu", with_alias=alias), torch.from_numpy(seeds),
                                             torch.from_numpy(mask), fan_out, False, keys, dedup_last=dedup_last)
    for jb, tb in zip(jblocks, tblocks):
        for name in jb._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jb, name)), getattr(tb, name).numpy(), err_msg=name)
    assert int(tstats["sampler_overflow"]) == int(jstats["sampler_overflow"])


def test_sampler_overflow_sums_the_alias_shortfall():
    """A long row with fewer than k positive-weight edges falls short on
    every call: ``sampler_overflow`` counts its unfilled slots per hop."""
    w = [1.0, 1.0] + [0.0] * 10  # deg 12 > 2k for k = 3; 2 drawable edges
    _, thg = _row0_graph(w)
    g = thg.to_device("cpu", with_alias=True)
    seeds = torch.zeros(4, dtype=torch.int32)
    _, stats = tsampler.sample_blocks(g, seeds, torch.ones(4, dtype=torch.bool), (3,), False,
                                      torch.Generator().manual_seed(0))
    assert int(stats["sampler_overflow"]) == 4 * (3 - 2)


@pytest.fixture(scope="module")
def weighted_data():
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=400, avg_degree=5, feature_dim=12, num_classes=6, train_frac=0.3, with_probs=True, seed=1
    )
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"], probs=arrays["probs"])
    thg = tgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"], probs=arrays["probs"])
    return arrays, meta, jhg, thg


def test_train_step_weighted_matches_jax(weighted_data):
    """3 SAGE train steps on a weighted graph with alias tables: the port's
    Trainer against JAX's on the same weights (``weights.py``) and keys."""
    arrays, meta, jhg, thg = weighted_data
    fan_out = (4, 3, 2)
    jm = JSAGE(12, 16, meta["num_classes"], 3)
    tm = TSAGE(12, 16, meta["num_classes"], 3, device="cpu")
    jp = jm.init(jax.random.key(0))
    tm.load_state_dict(sage_params_from_jax(jax.tree.map(np.asarray, jp)))
    jtr = JTrainer(model=jm, fan_out=fan_out, dedup_last=False)
    ttr = TTrainer(model=tm, fan_out=fan_out, dedup_last=False, device="cpu")
    jg, tg = jhg.to_device(with_alias=True), thg.to_device("cpu", with_alias=True)
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
        k_sample, k_drop = jax.random.split(jax.random.fold_in(key, step))
        jblocks, _ = jsampler.sample_blocks(jg, js, jmask, fan_out, False, k_sample, dedup_last=False)
        hk = jax.random.split(k_sample, len(fan_out))
        hop = [(_t(jprng.random_keys(hk[i], (2, b.num_dst, 4 * k))),
                _t(jprng.random_keys(jax.random.fold_in(hk[i], 1), (b.num_dst, 2 * k))))
               for i, (b, k) in enumerate(zip(jblocks, reversed(fan_out)))]
        drop, rng = [], k_drop
        for b in list(reversed(jblocks))[:-1]:
            rng, sub = jax.random.split(rng)
            drop.append(_t(jprng.random_keys(sub, (b.num_dst,))))
        if step == 0:
            safe = jnp.where(jblocks[-1].frontier_mask, jblocks[-1].frontier, 0)
            blab = jnp.where(jmask, labels[jnp.where(jmask, js, 0)], 0)
            (jloss, _), jgrads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
                state.params, jblocks, feats[safe], blab, jmask, k_drop
            )
        state, jmet = jtr.train_step(state, jg, feats, labels, js, jmask, key)
        tmet = ttr.train_step(tg, tfeats, tlabels, torch.from_numpy(seeds), torch.from_numpy(mask), (hop, drop))
        np.testing.assert_allclose(float(jmet["loss"]), float(tmet["loss"]), rtol=1e-4, atol=1e-4)
        assert int(tmet["sampler_overflow"]) == int(jmet["sampler_overflow"])
        if step == 0:
            np.testing.assert_allclose(float(jloss), float(tmet["loss"]), rtol=1e-5, atol=1e-5)
            for name, p in tm.named_parameters():
                layer, leaf = name.split(".")
                np.testing.assert_allclose(np.asarray(jgrads[layer][leaf]), p.grad.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=name)
    assert tsampling.sample_biased_alias.launches == 0


def test_weighted_training_and_serving_run_on_a_generator(weighted_data):
    """``train_step``, ``train_step_multi`` and ``eval_step`` take a weighted
    graph with no new knob: the graph decides the sampler."""
    arrays, meta, _, thg = weighted_data
    for alias in (False, True):
        tg = thg.to_device("cpu", with_alias=alias)
        tm = TSAGE(12, 16, meta["num_classes"], 2, generator=torch.Generator().manual_seed(0), device="cpu")
        tr = TTrainer(model=tm, fan_out=(3, 3), device="cpu")
        feats, labels = torch.from_numpy(arrays["features"]), torch.from_numpy(arrays["labels"])
        seeds = torch.from_numpy(arrays["train_idx"][:32])
        gen = torch.Generator().manual_seed(1)
        met = tr.train_step(tg, feats, labels, seeds, torch.ones(32, dtype=torch.bool), gen)
        # K7 is exact; the alias sampler may fall short (counted) on a long row
        assert np.isfinite(float(met["loss"])) and (int(met["sampler_overflow"]) == 0 or alias)
        multi = tr.train_step_multi(tg, feats, labels, seeds.reshape(2, 16), torch.ones(2, 16, dtype=torch.bool), gen)
        assert np.isfinite(float(multi["loss"]))
        correct, count = tr.eval_step(None, tg, feats, labels, seeds, torch.ones(32, dtype=torch.bool), gen)
        assert int(count) == 32 and 0 <= int(correct) <= 32
