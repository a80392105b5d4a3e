"""K7 and K8, the weighted samplers' kernels: a numpy model of each
kernel's per-row algorithm held to the port's plain versions (and those to
the JAX package), and the wrappers' contract.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
``sample_biased_plain`` and ``sample_biased_alias_plain`` there.  The
models below compute each row the way ``csrc/sampling.cu`` does:

* K7 without replacement: lanes take 32 consecutive edges, a ballot picks
  the lanes whose key beats the list's k-th at the chunk's start, and
  those are inserted in lane order after a re-check, at the count of list
  entries >= the key;
* K7 with replacement: f32 sums added one weight at a time, chunk by
  chunk, and each draw's walk that stops at the first running sum above
  its target;
* K8: a short row's keys ranked by counting, a long row's first distinct
  draws ranked by ballot popcounts in rounds of 32.

Every f32 operation is a numpy float32 operation in the kernel's order
(the kernel uses the round-to-nearest intrinsics, which never fuse), and
the log is taken in double and rounded once.  Tolerance: exact (ids, mask
and the shortfall count).
"""

import jax
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.ops import sampling as jsampling
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch.kernels import build, launch
from dist_gnn_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
INVALID = int(jgraph.INVALID_ID)
F32 = np.float32


def _mix32(x):
    x = np.uint32(x)
    x = x ^ (x >> np.uint32(16))
    x = np.uint32((int(x) * 0x85EBCA6B) & 0xFFFFFFFF)
    x = x ^ (x >> np.uint32(13))
    x = np.uint32((int(x) * 0xC2B2AE35) & 0xFFFFFFFF)
    return x ^ (x >> np.uint32(16))


def _uniform(bits):
    u = F32(int(bits) >> 8) * F32(2.0**-24)
    return max(u, F32(2.0**-25))


def _gumbel(bits, w):
    return F32(F32(np.log(np.float64(_uniform(bits)))) / F32(w))


def _extent(indptr, seed, n):
    if seed == INVALID:
        return 0, 0, False
    node = min(max(seed, 0), n - 1)
    return int(indptr[node]), int(indptr[node + 1] - indptr[node]), True


LONG_ROW, TOPK_WARPS = 1024, 16  # csrc/sampling.cu kLongRow, kTopkWarps (k <= 384)


def _beats(ka, oa, kb, ob):
    return ka > kb or (ka == kb and oa < ob)


def _insert(lk, lo, k, ck, co):
    if len(lk) == k and not _beats(ck, co, lk[k - 1], lo[k - 1]):
        return
    p = sum(1 for v, o in zip(lk, lo) if _beats(v, o, ck, co))
    lk.insert(p, ck)
    lo.insert(p, co)
    del lk[k:], lo[k:]


def _topk_pass(start, deg, rk, probs, E, k, c0, cstep):
    """One warp's pass over chunks c0, c0 + cstep, ...: the ballot against
    the list's k-th at each chunk's start, then insertions in lane order."""
    lk, lo = [], []
    for base in range(c0 * 32, deg, cstep * 32):
        lane_keys = []
        for lane in range(32):
            off = base + lane
            key = -np.inf
            if off < deg:
                w = probs[min(start + off, E - 1)]
                if w > 0:
                    key = _gumbel(_mix32(np.uint32(rk) ^ _mix32(np.uint32(off))), w)
            lane_keys.append(key)
        thr = lk[k - 1] if len(lk) == k else -np.inf
        for lane in [ln for ln in range(32) if lane_keys[ln] > thr]:
            _insert(lk, lo, k, lane_keys[lane], base + lane)
    return lk, lo


def model_k7_topk(indptr, indices, probs, seeds, keys, k):
    n, E = len(indptr) - 1, len(indices)
    ids = np.full((len(seeds), k), INVALID, np.int32)
    mask = np.zeros((len(seeds), k), bool)
    for b, seed in enumerate(seeds):
        start, deg, _ = _extent(indptr, seed, n)
        if deg <= LONG_ROW:  # a warp's own row
            lk, lo = _topk_pass(start, deg, keys[b], probs, E, k, 0, 1)
        else:  # shared by the block's warps, merged into warp 0's list
            parts = [_topk_pass(start, deg, keys[b], probs, E, k, w, TOPK_WARPS) for w in range(TOPK_WARPS)]
            lk, lo = parts[0]
            for wk, wo in parts[1:]:
                for ck, co in zip(wk, wo):
                    if len(lk) == k and not _beats(ck, co, lk[k - 1], lo[k - 1]):
                        break
                    _insert(lk, lo, k, ck, co)
        for j in range(len(lk)):
            ids[b, j] = indices[min(start + lo[j], E - 1)]
            mask[b, j] = True
    return ids, mask


def model_k7_cdf(indptr, indices, probs, seeds, keys, k, chunk=256):
    n, E = len(indptr) - 1, len(indices)
    ids = np.full((len(seeds), k), INVALID, np.int32)
    mask = np.zeros((len(seeds), k), bool)
    for b, seed in enumerate(seeds):
        start, deg, valid = _extent(indptr, seed, n)
        w = probs[start:start + deg]
        total = F32(0)
        for c0 in range(0, deg, chunk):
            ct = F32(0)
            for x in w[c0:c0 + chunk]:
                ct = F32(ct + x)
            total = F32(total + ct)
        for t in range(k):
            target = F32(_uniform(keys[b, t]) * total)
            found, pick, before = False, 0, F32(0)
            for c0 in range(0, deg, chunk):
                local = F32(target - before)
                cs = F32(0)
                for i in range(c0, min(deg, c0 + chunk)):
                    cs = F32(cs + w[i])
                    if local >= 0 and cs > local:
                        found, pick = True, i
                        break
                if found:
                    break
                before = F32(before + cs)
            if valid and total > 0 and found:
                ids[b, t] = indices[min(start + pick, E - 1)]
                mask[b, t] = True
    return ids, mask


def _alias_draw(b0, b1, deg, start, ap, ai, E):
    j = int(b0) % max(deg, 1)
    pos = min(start + j, E - 1)
    return j if _uniform(b1) < ap[pos] else int(ai[pos])


def model_k8(indptr, indices, probs, ap, ai, seeds, bits, gkeys, k, replace):
    n, E = len(indptr) - 1, len(indices)
    B = len(seeds)
    ids = np.full((B, k), INVALID, np.int32)
    mask = np.zeros((B, k), bool)
    shortfall = 0
    for b, seed in enumerate(seeds):
        start, deg, valid = _extent(indptr, seed, n)
        if replace:
            if valid and deg > 0:
                for t in range(k):
                    sel = _alias_draw(bits[0, b, t], bits[1, b, t], deg, start, ap, ai, E)
                    ids[b, t], mask[b, t] = indices[min(start + sel, E - 1)], True
            continue
        D, T = 2 * k, 4 * k
        if deg <= D:
            sk = [(_gumbel(gkeys[b, o], probs[min(start + o, E - 1)])
                   if o < deg and probs[min(start + o, E - 1)] > 0 else -np.inf) for o in range(D)]
            for o in range(D):
                rank = sum(1 for j in range(D) if sk[j] > sk[o] or (sk[j] == sk[o] and j < o))
                if rank < k and valid and sk[o] > -np.inf:
                    ids[b, rank], mask[b, rank] = indices[min(start + o, E - 1)], True
        else:
            sd = [_alias_draw(bits[0, b, t], bits[1, b, t], deg, start, ap, ai, E) for t in range(T)]
            got = 0
            for t0 in range(0, T, 32):
                firsts = [t < T and sd[t] not in sd[:t] for t in range(t0, t0 + 32)]
                for lane, first in enumerate(firsts):
                    rank = got + sum(firsts[:lane])
                    if first and rank < k:
                        ids[b, rank], mask[b, rank] = indices[min(start + sd[t0 + lane], E - 1)], True
                got += sum(firsts)
            shortfall += max(k - got, 0)
    return ids, mask, shortfall


# ---- the inputs: rows at the kernels' edges ----------------------------------


def _edge_graph(k, seed=0, indptr_dtype=np.int32):
    """Rows of degree 0, 1, k, 2k, 2k + 1, 31, 32, 33, 300 (over chunks of
    256), an all-zero-weight row, a row of equal weights (ties), 1025 and
    3000 (above K7's long-row limit: shared by a block), then random rows;
    about a tenth of the weights 0."""
    rng = np.random.default_rng(seed)
    degs = [0, 1, k, 2 * k, 2 * k + 1, 31, 32, 33, 300, 7, 9, 1025, 3000] + list(rng.integers(0, 40, 60))
    n = len(degs) + 5
    dst = np.repeat(np.arange(len(degs)), degs)
    src = rng.integers(0, n, len(dst))
    w = np.abs(rng.standard_normal(len(dst))).astype(np.float32)
    w[rng.random(len(w)) < 0.1] = 0
    indptr = np.concatenate([[0], np.cumsum(degs), np.full(5, len(dst))])
    w[indptr[9]:indptr[10]] = 0  # all zero
    w[indptr[10]:indptr[11]] = 0.5  # equal weights
    hg = tgraph.HostGraph.from_coo(src, dst, n, probs=w)
    hg = tgraph.HostGraph(indptr=hg.indptr.astype(indptr_dtype), indices=hg.indices, probs=hg.probs)
    seeds = np.concatenate([np.arange(13), rng.integers(0, n, 50)]).astype(np.int32)
    seeds[::13] = INVALID
    return hg, seeds


def _np(hg):
    return hg.indptr.astype(np.int64), hg.indices, hg.probs


@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 3, 15, 40])
def test_k7_topk_model_equals_plain(k, indptr_dtype):
    hg, seeds = _edge_graph(k, k, indptr_dtype)
    keys = tsampling.prng.random_keys(torch.Generator().manual_seed(k), (len(seeds),))
    got = tsampling.sample_biased_plain(hg.to_device("cpu"), torch.from_numpy(seeds), k, False, keys)
    ids, mask = model_k7_topk(*_np(hg), seeds, keys.numpy(), k)
    np.testing.assert_array_equal(ids, got.ids.numpy())
    np.testing.assert_array_equal(mask, got.mask.numpy())
    assert not mask[9].any()  # the all-zero row
    assert mask[10].sum() == min(9, k)  # equal weights: keys differ by u alone
    assert mask[11].all() and mask[12].all()  # the block-shared long rows


@pytest.mark.parametrize("k", [1, 4, 33])
def test_k7_cdf_model_equals_plain_and_jax(k):
    hg, seeds = _edge_graph(k, 50 + k)
    key = jax.random.key(k)
    keys = torch.from_numpy(np.asarray(jprng.random_keys(key, (len(seeds), k))).astype(np.int64))
    got = tsampling.sample_biased_plain(hg.to_device("cpu"), torch.from_numpy(seeds), k, True, keys)
    ids, mask = model_k7_cdf(*_np(hg), seeds, keys.numpy(), k)
    np.testing.assert_array_equal(ids, got.ids.numpy())
    np.testing.assert_array_equal(mask, got.mask.numpy())
    jg = jgraph.HostGraph(indptr=hg.indptr, indices=hg.indices, probs=hg.probs).to_device()
    want = jsampling.sample_biased(jg, seeds, k, True, key)
    np.testing.assert_array_equal(ids, np.asarray(want.ids))


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("replace", [False, True])
def test_k8_model_equals_plain(replace, k):
    hg, seeds = _edge_graph(k, 100 + k)
    g = hg.to_device("cpu", with_alias=True)
    gen = torch.Generator().manual_seed(k)
    B = len(seeds)
    bits = tsampling.prng.random_keys(gen, (2, B, k if replace else 4 * k))
    gkeys = tsampling.prng.random_keys(gen, (B, 2 * k))
    key = bits if replace else (bits, gkeys)
    got = tsampling.sample_biased_alias_plain(g, torch.from_numpy(seeds), k, replace, key)
    ids, mask, short = model_k8(*_np(hg), g.alias_prob.numpy(), g.alias_idx.numpy(), seeds, bits.numpy(),
                                gkeys.numpy(), k, replace)
    np.testing.assert_array_equal(ids, got.ids.numpy())
    np.testing.assert_array_equal(mask, got.mask.numpy())
    assert short == int(got.overflow)


def test_k8_model_counts_a_shortfall():
    """A long row with 2 drawable edges and k = 4: every call falls short
    by 2, in the model and the plain version alike."""
    indptr = np.array([0, 12], np.int64)
    w = np.zeros(12, np.float32)
    w[[3, 7]] = 1.0
    hg = tgraph.HostGraph(indptr=indptr, indices=np.arange(12, dtype=np.int32) + 5, probs=w)
    g = hg.to_device("cpu", with_alias=True)
    gen = torch.Generator().manual_seed(0)
    seeds = np.zeros(6, np.int32)
    bits, gkeys = tsampling.prng.random_keys(gen, (2, 6, 16)), tsampling.prng.random_keys(gen, (6, 8))
    got = tsampling.sample_biased_alias_plain(g, torch.from_numpy(seeds), 4, False, (bits, gkeys))
    ids, mask, short = model_k8(*_np(hg), g.alias_prob.numpy(), g.alias_idx.numpy(), seeds, bits.numpy(),
                                gkeys.numpy(), 4, False)
    np.testing.assert_array_equal(ids, got.ids.numpy())
    assert short == int(got.overflow) == 6 * 2
    assert set(ids[mask].tolist()) == {8, 12}


# ---- the wrappers' contract ----------------------------------------------------


def test_cpu_wrappers_launch_nothing_and_equal_the_plain_versions():
    hg, seeds = _edge_graph(3)
    g = hg.to_device("cpu", with_alias=True)
    s = torch.from_numpy(seeds)
    for replace in (False, True):
        for fn, plain in ((tsampling.sample_biased, tsampling.sample_biased_plain),
                          (tsampling.sample_biased_alias, tsampling.sample_biased_alias_plain)):
            a = fn(g, s, 3, replace, torch.Generator().manual_seed(4))
            b = plain(g, s, 3, replace, torch.Generator().manual_seed(4))
            assert torch.equal(a.ids, b.ids) and torch.equal(a.mask, b.mask)
    assert tsampling.sample_biased.launches == tsampling.sample_biased_alias.launches == 0


def _meta_graph(hg, alias=True, probs_dtype=torch.float32):
    E = hg.num_edges

    def meta(n, dtype):
        return torch.empty(n, dtype=dtype, device="meta")

    return tgraph.Graph(indptr=meta(hg.num_nodes + 1, torch.int32), indices=meta(E, torch.int32),
                        probs=meta(E, probs_dtype), num_nodes=hg.num_nodes, num_edges=E, max_degree=hg.max_degree,
                        alias_prob=meta(E, torch.float32) if alias else None,
                        alias_idx=meta(E, torch.int32) if alias else None)


@pytest.mark.parametrize("fn", ["sample_biased", "sample_biased_alias"])
def test_tensors_off_the_cpu_never_take_the_plain_version(fn):
    """A 'meta' tensor is neither on the CPU nor on a CUDA device: each
    wrapper raises before anything launches."""
    hg, _ = _edge_graph(3)
    seeds = torch.empty(10, dtype=torch.int32, device="meta")
    for replace in (False, True):
        with pytest.raises(ValueError):
            getattr(tsampling, fn)(_meta_graph(hg), seeds, 3, replace, torch.Generator().manual_seed(0))
    assert getattr(tsampling, fn).launches == 0


@pytest.mark.parametrize(
    "case", ["no_alias", "f64_probs", "k_too_large", "short_probs"],
)
def test_weighted_checks_refuse_what_the_kernels_do_not_take(monkeypatch, case):
    """Past K6's device checks (patched out here: no card), K7 and K8 need
    f32 [E] weights, K8 its alias tables, and k <= MAX_K."""
    hg, _ = _edge_graph(3)
    monkeypatch.setattr(tsampling, "_check_graph", lambda graph, seeds: None)
    g = _meta_graph(hg, alias=case != "no_alias", probs_dtype=torch.float64 if case == "f64_probs" else torch.float32)
    if case == "short_probs":
        g = tgraph.Graph(**{**g.__dict__, "probs": torch.empty(3, device="meta")})
    k = tsampling.MAX_K + 1 if case == "k_too_large" else 3
    seeds = torch.empty(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tsampling._check_weighted(g, seeds, k, alias=True)
    if case in ("f64_probs", "k_too_large", "short_probs"):
        with pytest.raises(ValueError):
            tsampling._check_weighted(g, seeds, k, alias=False)
    else:
        tsampling._check_weighted(g, seeds, k, alias=False)


def test_a_tensor_off_the_current_device_raises(monkeypatch):
    """The launch takes the current stream of the current device; a tensor
    on another CUDA device raises instead of launching there."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)

    class OnDevice1:
        device = "cuda:1"

        def get_device(self):
            return 1

    with pytest.raises(ValueError, match="current CUDA device"):
        launch.stream_of(OnDevice1())


def test_injected_alias_keys_are_checked():
    hg, seeds = _edge_graph(3)
    g = hg.to_device("cpu", with_alias=True)
    s = torch.from_numpy(seeds)
    B = len(seeds)
    with pytest.raises(ValueError):
        tsampling.sample_biased_alias(g, s, 3, False, (torch.zeros(2, B, 3), torch.zeros(B, 6)))
    with pytest.raises(ValueError):
        tsampling.sample_biased_alias(g, s, 3, True, torch.zeros(2, B, 4))
    with pytest.raises(ValueError):
        tsampling.sample_biased(g, s, 3, True, torch.zeros(B))


def test_the_weighted_kernels_are_built_with_the_others():
    src = (build.CSRC_DIR / "sampling.cu").read_text()
    assert "sampling" in build.SOURCES
    for name in ("dg_sample_biased(", "dg_sample_biased_alias("):
        assert name in src
    assert "--use_fast_math" not in build.NVCC_FLAGS  # log and the divisions stay exact


def test_k7_fast_log_filter_never_drops_a_candidate():
    """K7's ``cannot_beat``: an edge is skipped only if its exact key cannot
    beat the list's k-th.  With __logf off by its documented worst case
    (2^-21.41 absolute on [0.5, 2], 3 ulp elsewhere) in either direction,
    the filter in f32 arithmetic never rejects an edge whose exact key
    beats thr, including keys within an ulp of thr."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    u = np.maximum((bits >> np.uint32(8)).astype(np.float32) * F32(2.0**-24), F32(2.0**-25))
    w = np.abs(rng.standard_normal(len(u))).astype(np.float32) + F32(1e-3)
    lg = np.log(u.astype(np.float64)).astype(np.float32)
    key = (lg / w).astype(np.float32)
    # thresholds at and around each key: one ulp below, equal, a ulp above
    for thr in (np.nextafter(key, F32(-np.inf)), key, np.nextafter(key, F32(np.inf)),
                (key * F32(1.001)).astype(np.float32)):
        err = np.where(u >= 0.5, F32(2.0**-21.41), F32(3) * np.spacing(np.abs(lg)))
        for sign in (-1, 1):
            lgf = (lg + sign * err).astype(np.float32)
            bound = (thr * w).astype(np.float32)
            rejected = (lgf + F32(1e-6) + F32(1e-6) * np.abs(lgf) + F32(1e-6) * np.abs(bound)) < bound
            assert not (rejected & (key > thr)).any()
    # and it does reject most edges far below the threshold
    thr = np.full_like(key, F32(-0.5))
    lgf = lg
    rejected = (lgf + F32(1e-6) + F32(1e-6) * np.abs(lgf) + F32(1e-6) * np.abs(thr * w)) < thr * w
    assert rejected.mean() > 0.5 and not (rejected & (key > thr)).any()
