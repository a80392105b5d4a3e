"""K6, the uniform sampler's kernel: a numpy model of its per-element
algorithm against the JAX package and the port's plain version, and the
wrapper contract.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
``sample_uniform_plain`` there, bit for bit.  Here the model below computes
each (row, slot) the way ``csrc/sampling.cu`` does: native uint32
arithmetic that wraps, a cycle walk that stops as soon as the value is in
range, the ``y % deg`` fallback after 12 steps.  It must equal JAX's
``feistel_permutation`` / ``sample_uniform`` on JAX's injected keys and
the port's plain version, so the kernel's shortcuts change no bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.ops import sampling as jsampling
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.ops import prng as tprng
from dist_gnn_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
INVALID = int(jgraph.INVALID_ID)
_ONE = np.uint32(1)
_GOLDEN = np.uint32(0x9E3779B9)
# r * 0x7F4A7C15 for the 8 rounds, wrapped in uint32 as the kernel's product
_ROUND_KEYS = np.arange(8, dtype=np.uint32) * np.uint32(0x7F4A7C15)


# ---- the model: csrc/sampling.cu, element by element ------------------------


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _feistel(x, lo, hi, key):
    wb, wa = lo, hi
    b = x & ((_ONE << wb) - _ONE)
    a = (x >> wb) & ((_ONE << wa) - _ONE)
    for r in range(8):
        f = _mix32((b * _GOLDEN) ^ (key + _ROUND_KEYS[r]))
        a, b = b, a ^ (f & ((_ONE << wa) - _ONE))
        wa, wb = wb, wa
    return (a << wb) | b


def _bit_length(v):
    """32 - clz(v) per element (uint32 in, uint32 out)."""
    bits = np.zeros_like(v)
    v = v.copy()
    while (v > 0).any():
        bits += (v > 0).astype(np.uint32)
        v >>= _ONE
    return bits


def _k6_walk(j, d, key):
    """The cycle walk of the kernel's permutation for d >= 2: the Feistel
    network at j, then up to 12 more passes, each only for the elements
    still out of range.  Returns (y, d) as uint32; y >= d where the walk
    ran out."""
    j, d, key = (np.asarray(a, dtype=np.uint32).copy() for a in (j, d, key))
    bits = np.maximum(_bit_length(d - _ONE), np.uint32(2))
    lo = (bits + _ONE) >> _ONE
    hi = bits - lo
    y = _feistel(j, lo, hi, key)
    for _ in range(12):
        walk = y >= d
        if not walk.any():
            break
        y[walk] = _feistel(y[walk], lo[walk], hi[walk], key[walk])
    return y, d


def k6_permutation(j, d, key):
    """The keyed permutation of [0, d) at j for d >= 2, as the kernel
    computes it: each element walks only while it is out of range, and one
    still out of range after 12 steps takes ``y % d``."""
    y, d = _k6_walk(j, d, key)
    return np.where(y < d, y, y % d)


def k6_model(indptr, indices, seeds, keys, k, replace):
    """ids [B, k] int32 and mask [B, k] bool of one K6 call on numpy
    inputs (keys uint32: [B] without replacement, [B, k] with)."""
    B, N, E = seeds.shape[0], indptr.shape[0] - 1, indices.shape[0]
    ids = np.full((B, k), INVALID, np.int32)
    mask = np.zeros((B, k), bool)
    if E == 0 or B * k == 0:
        return ids, mask
    valid = seeds != INVALID
    node = np.clip(np.where(valid, seeds, 0), 0, N - 1).astype(np.int64)
    start = indptr[node].astype(np.int64)
    deg = np.where(valid, (indptr[node + 1].astype(np.int64) - start).astype(np.int32), 0)
    J = np.broadcast_to(np.arange(k, dtype=np.int64), (B, k))
    D = np.broadcast_to(deg[:, None], (B, k)).astype(np.int64)
    if replace:
        take = D > 0
        sel = np.where(take, keys.astype(np.int64) % np.maximum(D, 1), 0)
    else:
        take = J < np.minimum(D, k)
        walk = take & (D > k)
        sel = J.copy()
        row_key = np.broadcast_to(keys[:, None], (B, k))
        sel[walk] = k6_permutation(J[walk], D[walk], row_key[walk])
    pos = np.clip(start[:, None] + sel, 0, E - 1)
    ids[take] = indices[pos[take]]
    mask[take] = True
    return ids, mask


# ---- inputs ------------------------------------------------------------------


_HUB = 10  # the hub's node id in _edge_graph


def _edge_graph(k, seed=0):
    """A CSC graph whose rows have degree 0, 1, k, k + 1, 2^b and 2^b + 1
    for b = 3, 5, 7, and one hub of 3000; plus random rows of degree up to
    40.  Returns (src, dst, n) for both packages' ``from_coo`` and the node
    ids of the special rows."""
    rng = np.random.default_rng(seed)
    degs = [0, 1, k, k + 1] + [d for b in (3, 5, 7) for d in (2**b, 2**b + 1)] + [3000]
    assert degs[_HUB] == 3000
    degs += list(rng.integers(0, 41, 60))
    n = len(degs) + 20  # 20 more nodes with no in-edges
    dst = np.repeat(np.arange(len(degs)), degs)
    src = rng.integers(0, n, dst.shape[0])
    return src, dst, n, np.arange(len(degs))


def _seeds(nodes, n, rows, seed):
    rng = np.random.default_rng(seed)
    seeds = np.concatenate([nodes, rng.integers(0, n, rows - nodes.shape[0])]).astype(np.int32)
    seeds = seeds[rng.permutation(rows)]
    seeds[::9] = INVALID  # padded rows
    return seeds


def _host(src, dst, n, indptr_dtype):
    thg = tgraph.HostGraph.from_coo(src, dst, n)
    return tgraph.HostGraph(indptr=thg.indptr.astype(indptr_dtype), indices=thg.indices)


# ---- the model against JAX -------------------------------------------------


DOMAINS = [2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 33, 1000, 1024, 65536, 2**20 + 3, 2**31 - 1]


@pytest.mark.parametrize("domain", DOMAINS)
def test_model_permutation_equals_jax_and_plain(domain):
    R, J = 64, min(domain, 40)
    keys = np.random.default_rng(domain % 101).integers(0, 2**32, R, dtype=np.uint64).astype(np.uint32)
    j = np.broadcast_to(np.arange(J, dtype=np.int32), (R, J)).copy()
    d = np.full((R, 1), domain, np.int32)
    ref = np.asarray(jprng.feistel_permutation(jnp.asarray(j), jnp.asarray(d), jnp.asarray(keys)[:, None]))
    got = k6_permutation(j, np.broadcast_to(d, (R, J)), np.broadcast_to(keys[:, None], (R, J)))
    np.testing.assert_array_equal(ref.astype(np.int64), got.astype(np.int64))
    plain = tprng.feistel_permutation(torch.from_numpy(j), torch.from_numpy(d),
                                      torch.from_numpy(keys.astype(np.int64))[:, None])
    np.testing.assert_array_equal(got.astype(np.int64), plain.numpy().astype(np.int64))


def test_model_walk_fallback_equals_jax():
    """Keys whose walks run long: at a domain just above a power of two
    half of the walked domain lies outside, so some of 20,000 elements walk
    more than a few steps and at least one runs out of its 12 and takes the
    ``y % d`` fallback; the early exit must change none of them."""
    d = 2**12 + 1
    keys = np.random.default_rng(5).integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)
    j = np.random.default_rng(6).integers(0, d, 20_000).astype(np.int32)
    y, _ = _k6_walk(j, np.full(j.shape, d), keys)
    assert (y >= d).sum() > 0, "no element reached the fallback: the case tests nothing"
    ref = np.asarray(jprng.feistel_permutation(jnp.asarray(j), jnp.full_like(jnp.asarray(j), d),
                                               jnp.asarray(keys)))
    got = k6_permutation(j, np.full(j.shape, d), keys)
    np.testing.assert_array_equal(ref.astype(np.int64), got.astype(np.int64))
    assert (got < d).all()


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("k", [1, 5, 15])
def test_model_sample_equals_jax_and_plain(replace, k):
    src, dst, n, special = _edge_graph(k, seed=k)
    jg = jgraph.HostGraph.from_coo(src, dst, n).to_device()
    seeds = _seeds(special, n, 160, seed=k)
    key = jax.random.key(30 + k)
    shape = (160, k) if replace else (160,)
    keys = np.asarray(jprng.random_keys(key, shape))
    ref = jsampling.sample_uniform(jg, jnp.asarray(seeds), k=k, replace=replace, key=key)
    ref_ids = np.asarray(ref.ids)
    ref_mask = np.broadcast_to(np.asarray(ref.mask), (160, k))  # JAX keeps [B, 1] when replace
    for indptr_dtype in (np.int32, np.int64):
        hg = _host(src, dst, n, indptr_dtype)
        ids, mask = k6_model(hg.indptr, hg.indices, seeds, keys, k, replace)
        np.testing.assert_array_equal(ref_ids, ids)
        np.testing.assert_array_equal(ref_mask, mask)
        out = tsampling.sample_uniform_plain(hg.to_device("cpu"), torch.from_numpy(seeds), k, replace,
                                             torch.from_numpy(keys.astype(np.int64)))
        np.testing.assert_array_equal(ids, out.ids.numpy())
        np.testing.assert_array_equal(mask, out.mask.numpy())
    assert not mask[seeds == INVALID].any()
    assert mask[seeds == special[_HUB]].all()  # the hub fills its rows


@pytest.mark.parametrize("replace", [False, True])
def test_model_degrees_at_the_edges(replace):
    """Each special row alone: a row of degree <= k takes j (or bits % deg)
    for every valid slot, deg 0 and INVALID rows are empty, a row above k
    takes k distinct positions of its list."""
    k = 5
    src, dst, n, special = _edge_graph(k, seed=1)
    hg = _host(src, dst, n, np.int32)
    seeds = np.concatenate([special[:11], [INVALID]]).astype(np.int32)
    keys = np.random.default_rng(2).integers(0, 2**32, (12, k) if replace else 12,
                                             dtype=np.uint64).astype(np.uint32)
    ids, mask = k6_model(hg.indptr, hg.indices, seeds, keys, k, replace)
    degs = np.diff(hg.indptr)[special[:11]]
    for row, d in enumerate(degs):
        want = (d > 0) * k if replace else min(d, k)
        assert mask[row].sum() == want
        lst = hg.indices[hg.indptr[seeds[row]] : hg.indptr[seeds[row] + 1]]
        assert np.isin(ids[row][mask[row]], lst).all()
        if not replace and d <= k:
            np.testing.assert_array_equal(ids[row][: d], lst)
    assert not mask[-1].any() and (ids[-1] == INVALID).all()
    out = tsampling.sample_uniform(hg.to_device("cpu"), torch.from_numpy(seeds), k, replace,
                                   torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(ids, out.ids.numpy())
    np.testing.assert_array_equal(mask, out.mask.numpy())


@pytest.mark.parametrize("replace", [False, True])
def test_plain_positions_are_the_reads_of_the_model(replace):
    """``plain_positions`` (which chip_smoke's K6 bound counts sectors
    from) gives the model's mask, and positions inside each taken row's
    list whose entries are the sampled ids; a row of degree <= k reads its
    list from the start, in order."""
    k = 5
    src, dst, n, special = _edge_graph(k, seed=4)
    hg = _host(src, dst, n, np.int32)
    seeds = _seeds(special, n, 120, seed=5)
    keys = np.random.default_rng(6).integers(0, 2**32, (120, k) if replace else 120,
                                             dtype=np.uint64).astype(np.uint32)
    ids, mask = k6_model(hg.indptr, hg.indices, seeds, keys, k, replace)
    pos, pmask = tsampling.plain_positions(hg.to_device("cpu"), torch.from_numpy(seeds), k, replace,
                                           torch.from_numpy(keys.astype(np.int64)))
    pos, pmask = pos.numpy(), pmask.numpy()
    np.testing.assert_array_equal(mask, pmask)
    np.testing.assert_array_equal(hg.indices[pos[mask]], ids[mask])
    node = np.where(seeds != INVALID, seeds, 0)
    start, end = hg.indptr[node][:, None], hg.indptr[node + 1][:, None]
    assert ((pos >= start) & (pos < end))[mask].all()
    if not replace:
        short = (seeds != INVALID) & (end[:, 0] - start[:, 0] <= k)
        np.testing.assert_array_equal((pos - start)[short][mask[short]],
                                      np.broadcast_to(np.arange(k), (120, k))[short][mask[short]])


@pytest.mark.parametrize("replace", [False, True])
def test_model_empty_graph_and_empty_batch(replace):
    hg = tgraph.HostGraph(indptr=np.zeros(8, np.int32), indices=np.zeros(0, np.int32))
    seeds = np.array([0, 3, INVALID, 6], np.int32)
    keys = np.arange(4 * 3 if replace else 4, dtype=np.uint32).reshape((4, 3) if replace else (4,))
    ids, mask = k6_model(hg.indptr, hg.indices, seeds, keys, 3, replace)
    out = tsampling.sample_uniform(hg.to_device("cpu"), torch.from_numpy(seeds), 3, replace,
                                   torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(ids, out.ids.numpy())
    np.testing.assert_array_equal(mask, out.mask.numpy())
    assert (ids == INVALID).all() and not mask.any()
    src, dst, n, _ = _edge_graph(3)
    g = _host(src, dst, n, np.int32).to_device("cpu")
    empty = tsampling.sample_uniform(g, torch.zeros(0, dtype=torch.int32), 3, replace,
                                     torch.zeros((0, 3) if replace else (0,), dtype=torch.int64))
    assert empty.ids.shape == (0, 3) and empty.mask.shape == (0, 3)


# ---- the wrapper contract --------------------------------------------------


def test_cpu_sample_uniform_launches_nothing():
    src, dst, n, special = _edge_graph(4)
    g = _host(src, dst, n, np.int32).to_device("cpu")
    seeds = torch.from_numpy(_seeds(special, n, 100, seed=3))
    for replace in (False, True):
        a = tsampling.sample_uniform(g, seeds, 4, replace, torch.Generator().manual_seed(9))
        b = tsampling.sample_uniform_plain(g, seeds, 4, replace, torch.Generator().manual_seed(9))
        assert torch.equal(a.ids, b.ids) and torch.equal(a.mask, b.mask)
    assert tsampling.sample_uniform.launches == 0


@pytest.mark.parametrize("where", ["seeds", "graph"])
def test_non_cpu_tensors_never_take_the_plain_version(where):
    """Seeds off the CPU must reach K6 or raise; the 'meta' device is not a
    CUDA device, so the wrapper refuses it, and so it refuses a graph that
    does not lie on the seeds' device."""
    src, dst, n, _ = _edge_graph(4)
    hg = _host(src, dst, n, np.int32)
    if where == "seeds":
        g = tgraph.Graph(indptr=torch.empty(n + 1, dtype=torch.int32, device="meta"),
                         indices=torch.empty(hg.num_edges, dtype=torch.int32, device="meta"),
                         probs=None, num_nodes=n, num_edges=hg.num_edges, max_degree=hg.max_degree)
        seeds = torch.empty(10, dtype=torch.int32, device="meta")
    else:
        g = hg.to_device("cpu")
        seeds = torch.empty(10, dtype=torch.int32, device="meta")
    for replace in (False, True):
        with pytest.raises(ValueError):
            tsampling.sample_uniform(g, seeds, 4, replace, torch.Generator().manual_seed(0))
    assert tsampling.sample_uniform.launches == 0


def test_the_sampler_kernel_is_built_with_the_others():
    assert "sampling" in build.SOURCES
    assert (build.CSRC_DIR / "sampling.cu").exists()
    src = (build.CSRC_DIR / "sampling.cu").read_text()
    assert "dg_sample_uniform" in src and "extern \"C\"" in src


# ---- sample_blocks on the CPU, unchanged against JAX -----------------------


@pytest.mark.parametrize("dedup_last", [True, False])
def test_sample_blocks_on_the_edge_graph_equal_jax(dedup_last):
    src, dst, n, special = _edge_graph(3, seed=7)
    fan_out = (3, 2)
    # a batch holds distinct seeds (JAX's dense relabel assumes it): the
    # special rows and 29 others, in a shuffled order, with padded slots
    rng = np.random.default_rng(8)
    seeds = np.concatenate([special[:11], rng.permutation(np.arange(11, n))[:29]]).astype(np.int32)
    seeds = seeds[rng.permutation(40)]
    seeds[::9] = INVALID
    mask = seeds != INVALID
    key = jax.random.key(12)
    jblocks, _ = jsampler.sample_blocks(
        jgraph.HostGraph.from_coo(src, dst, n).to_device(), jnp.asarray(seeds), jnp.asarray(mask),
        fan_out, False, key, dedup_last=dedup_last,
    )
    hop_keys = jax.random.split(key, len(fan_out))
    keys = [torch.from_numpy(np.asarray(jprng.random_keys(hop_keys[i], (b.num_dst,))).astype(np.int64))
            for i, b in enumerate(jblocks)]
    tblocks, _ = tsampler.sample_blocks(
        _host(src, dst, n, np.int64).to_device("cpu"), torch.from_numpy(seeds), torch.from_numpy(mask),
        fan_out, False, keys, dedup_last=dedup_last,
    )
    assert tsampling.sample_uniform.launches == 0
    for jb, tb in zip(jblocks, tblocks):
        for name in jb._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jb, name)), getattr(tb, name).numpy(),
                                          err_msg=name)


# ---- the kernels' order of work: blocks of slots and the walk queue ---------

_THREADS = 256  # csrc/sampling.cu kThreads
_QUEUE_SLOTS = 131072  # csrc/sampling.cu kQueueSlots


def _pass(x, d, key):
    """One pass of the network for domain d >= 2 (feistel_pass)."""
    x, d, key = (np.asarray(a, dtype=np.uint32) for a in (x, d, key))
    bits = np.maximum(_bit_length(d - _ONE), np.uint32(2))
    lo = (bits + _ONE) >> _ONE
    return _feistel(x, lo, bits - lo, key)


def k6_block_model(indptr, indices, seeds, keys, k, replace, rng, threads=_THREADS):
    """ids and mask of K6 as its packed kernel orders the work: a block takes
    ``threads`` consecutive flat slots, finds its first row by one division
    and each thread its row and slot from the remainder; each slot of a row
    longer than k runs the first pass where it is, and the slots still out
    of range join the block's queue, warp by warp in an order the atomics
    choose (``rng``), and walk on from there.  With replacement (which the
    in-place kernel takes at every size) no slot walks, and the blocks are
    that kernel's, a thread a slot.  Also returns how often each (b, j) was
    visited and the queue lengths."""
    B, N, E = seeds.shape[0], indptr.shape[0] - 1, indices.shape[0]
    total = B * k
    ids = np.full(total, INVALID, np.int32)
    mask = np.zeros(total, bool)
    visits = np.zeros((B, k), np.int64)
    queues = []
    for e0 in range(0, total, threads):
        b0 = e0 // k
        local = (e0 - b0 * k) + np.arange(threads)
        row = local // k
        b, j, e = b0 + row, local - row * k, e0 + np.arange(threads)
        live = e < total
        b, j, e = b[live], j[live], e[live]
        assert (b * k + j == e).all()
        np.add.at(visits, (b, j), 1)
        seed = seeds[b]
        valid = seed != INVALID
        node = np.clip(np.where(valid, seed, 0), 0, N - 1).astype(np.int64)
        start = np.where(valid, indptr[node].astype(np.int64), 0)
        deg = np.where(valid, (indptr[node + 1].astype(np.int64) - indptr[node]), 0).astype(np.int64)
        if replace:
            take = deg > 0
            sel = np.where(take, keys.reshape(-1)[e].astype(np.int64) % np.maximum(deg, 1), 0)
        else:
            take = j < np.minimum(deg, k)
            sel = j.astype(np.int64)
            first = take & (deg > k)
            key = keys[b].astype(np.uint32)
            y = np.zeros(e.shape[0], np.uint32)
            y[first] = _pass(j[first], deg[first], key[first])
            out = first & (y >= deg)
            # the queue: whole warps in the atomics' order, lanes in order
            warps = np.arange(0, e.shape[0], 32)
            order = np.concatenate([np.nonzero(out[w : w + 32])[0] + w for w in rng.permutation(warps)]
                                   + [np.zeros(0, np.int64)])
            queues.append(order.shape[0])
            for t in order:  # each queue entry walks on as one thread of the first warps would
                yy, dd, kk = y[t : t + 1], deg[t : t + 1].astype(np.uint32), key[t : t + 1]
                for _ in range(12):
                    if yy[0] < dd[0]:
                        break
                    yy = _pass(yy, dd, kk)
                y[t] = yy[0]
            walked = y.astype(np.int64)
            sel = np.where(first, np.where(walked < deg, walked, walked % np.maximum(deg, 1)), sel)
        pos = np.clip(start + sel, 0, E - 1)
        ids[e[take]] = indices[pos[take]]
        mask[e[take]] = True
    return ids.reshape(B, k), mask.reshape(B, k), visits, queues


@pytest.mark.parametrize("k", [1, 5, 15, 16, 17, 40])
@pytest.mark.parametrize("replace", [False, True])
def test_block_model_covers_each_slot_once_and_equals_jax_and_plain(k, replace):
    """Blocks of 256 slots over B rows of k slots: B is chosen so that the
    last block is ragged and blocks start mid-row; every (b, j) is visited
    once, and the block model, the element model, JAX's ``sample_uniform``
    on JAX's keys and the port's plain version agree, under int32 and int64
    indptr."""
    src, dst, n, special = _edge_graph(k, seed=40 + k)
    B = 700 + k  # B * k is not a multiple of 256 for any k here
    assert (B * k) % _THREADS
    seeds = _seeds(special, n, B, seed=k)
    key = jax.random.key(60 + k)
    shape = (B, k) if replace else (B,)
    keys = np.asarray(jprng.random_keys(key, shape))
    ref = jsampling.sample_uniform(jgraph.HostGraph.from_coo(src, dst, n).to_device(), jnp.asarray(seeds), k=k,
                                   replace=replace, key=key)
    ref_mask = np.broadcast_to(np.asarray(ref.mask), (B, k))
    for indptr_dtype in (np.int32, np.int64):
        hg = _host(src, dst, n, indptr_dtype)
        ids, mask, visits, queues = k6_block_model(hg.indptr, hg.indices, seeds, keys, k, replace,
                                                   np.random.default_rng(k))
        assert (visits == 1).all()
        np.testing.assert_array_equal(np.asarray(ref.ids), ids)
        np.testing.assert_array_equal(ref_mask, mask)
        np.testing.assert_array_equal((ids, mask), k6_model(hg.indptr, hg.indices, seeds, keys, k, replace))
        out = tsampling.sample_uniform_plain(hg.to_device("cpu"), torch.from_numpy(seeds), k, replace,
                                             torch.from_numpy(keys.astype(np.int64)))
        np.testing.assert_array_equal(ids, out.ids.numpy())
        np.testing.assert_array_equal(mask, out.mask.numpy())
    if not replace and k < 40:
        assert sum(queues) > 0  # some walks outlast the first pass: the queue is exercised


def test_block_model_on_the_hub_row_in_every_queue_order():
    """64 rows that are all the hub (3000 edges, k = 15): the walk on its
    domain, through the queue in three orders of the atomics, gives the
    element model's picks, k distinct positions a row."""
    k = 15
    src, dst, n, special = _edge_graph(k, seed=9)
    hg = _host(src, dst, n, np.int32)
    seeds = np.full(64, special[_HUB], np.int32)
    keys = np.random.default_rng(10).integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = k6_model(hg.indptr, hg.indices, seeds, keys, k, False)
    for order_seed in range(3):
        ids, mask, visits, queues = k6_block_model(hg.indptr, hg.indices, seeds, keys, k, False,
                                                   np.random.default_rng(order_seed))
        np.testing.assert_array_equal((ids, mask), want)
        assert (visits == 1).all() and mask.all() and sum(queues) > 0
    pos, _ = tsampling.plain_positions(hg.to_device("cpu"), torch.from_numpy(seeds), k, False,
                                       torch.from_numpy(keys.astype(np.int64)))
    assert all(len(set(r)) == k for r in pos.numpy().tolist())


def test_the_packed_kernel_takes_the_main_paths_last_hop_only():
    """The SAGE bench request's hops have 512 x 5, 3,072 x 10 and 33,792 x
    15 slots: only the last reaches the packed kernel's threshold, which
    the source sets."""
    from dist_gnn_tpu_torch.sampler import layer_capacities

    src = (build.CSRC_DIR / "sampling.cu").read_text()
    assert f"constexpr int64_t kQueueSlots = {_QUEUE_SLOTS};" in src
    assert f"constexpr int kThreads = {_THREADS};" in src
    hops = layer_capacities(512, (15, 10, 5))[:3]
    slots = [b * kk for b, kk in zip(hops, (5, 10, 15))]
    assert slots == [2560, 30720, 506880]
    assert [s >= _QUEUE_SLOTS for s in slots] == [False, False, True]
