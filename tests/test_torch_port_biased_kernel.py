"""K7 and K8, the weighted samplers' kernels: a numpy model of each
kernel's decomposition held to the port's plain versions (and those to
the JAX package), and the wrappers' contract.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
``sample_biased_plain`` and ``sample_biased_alias_plain`` there.  The
models below compute each row the way ``csrc/sampling.cu`` does:

* K7 without replacement: a row of at most ``SHORT_ROW`` edges is one
  warp's pass (lanes take 32 consecutive edges, a ballot picks the lanes
  whose key beats the list's k-th, and those are inserted in lane order
  after a re-check, at the count of list entries that beat the key); the
  longer rows are laid end to end on one line of edges, cut into equal
  ranges, one a warp, regardless of row boundaries; a row inside a range
  is finished there, the pieces of a split row share a lower bound of its
  k-th key (raised to each full list's k-th) and their lists are merged,
  k rounds of the largest head;
* K7 with replacement: each 256-edge chunk summed from 0 in row order, the
  chunk sums folded in order into the befores and the total, each draw's
  chunk the first whose local target is >= 0 and below its sum, and the
  walk of that chunk alone;
* K8: a group of G lanes a row (8, 16 or 32, the least that holds k), at
  its lanes of a warp; a short row's keys ranked by counting; a long row's
  draws read in rounds of min(G, k - got, T - t), each round's firsts the
  lowest lane of each value's match set less the values kept in earlier
  rounds (a register list for k <= 32, an open-addressed set above),
  ranked by ballot popcounts, the loop ending at the k-th first
  occurrence.

Every f32 operation is a numpy float32 operation in the kernel's order
(the kernel uses the round-to-nearest intrinsics, which never fuse), and
the log is taken in double and rounded once.  Tolerance: exact (ids, mask
and the shortfall count).
"""

from pathlib import Path

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


# csrc/sampling.cu: kShortRow, kMinPiece, kMaxPieces, kUnroll, kChunk; W on a
# 132-SM H100 (kSliceWarpsPerSM warps an SM)
SHORT_ROW, MIN_PIECE, MAX_PIECES, UNROLL, CHUNK = 1024, 1024, 256, 4, 256
SLICE_WARPS = 132 * 32
ORD_NEG_INF = 0x007FFFFF


def _beats(ka, oa, kb, ob):
    return ka > kb or (ka == kb and oa < ob)


def _ord(key):
    """The order-preserving bits of a float32 (the kernel's float_to_ord)."""
    u = int(np.float32(key).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _from_ord(o):
    u = (o & 0x7FFFFFFF) if o & 0x80000000 else (~o & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def _pack(key, off):
    """A merge entry (the kernel's pack_entry): larger beats smaller."""
    return (_ord(key) << 32) | (0xFFFFFFFF - off)


def _mix32_np(x):
    x = np.asarray(x, np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x.astype(np.uint64) * 0x85EBCA6B & 0xFFFFFFFF).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x.astype(np.uint64) * 0xC2B2AE35 & 0xFFFFFFFF).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def _row_keys(start, deg, rk, probs, E):
    """Every edge's Gumbel key in one row, -inf at zero weight (what
    ``_gumbel`` gives edge by edge)."""
    off = np.arange(deg, dtype=np.uint32)
    bits = _mix32_np(np.uint32(rk) ^ _mix32_np(off))
    u = np.maximum((bits >> np.uint32(8)).astype(np.float32) * F32(2.0**-24), F32(2.0**-25))
    lg = np.log(u.astype(np.float64)).astype(np.float32)
    w = probs[np.minimum(start + off.astype(np.int64), E - 1)]
    return np.where(w > 0, lg / np.where(w > 0, w, F32(1)), F32(-np.inf)).astype(np.float32)


def _insert(lk, lo, k, ck, co):
    if len(lk) == k and not _beats(ck, co, lk[k - 1], lo[k - 1]):
        return
    p = sum(1 for v, o in zip(lk, lo) if _beats(v, o, ck, co))
    lk.insert(p, ck)
    lo.insert(p, co)
    del lk[k:], lo[k:]


def _topk_range(keys, o0, o1, k, bound=None):
    """One warp's pass over a row's edges [o0, o1) (``topk_range``): each
    UNROLL steps of 32 edges the shared bound (``bound``, a one-element list
    of order bits, for a split row) is read; step by step the lanes whose key
    beats the list's k-th and is not below the bound are inserted in lane
    order; a full list then raises the bound to its k-th.  Edges the fast-log
    filter skips are below the threshold, so they fail the ballot here too."""
    lk, lo = [], []
    for first in range(o0, o1, UNROLL * 32):
        shared = _from_ord(bound[0]) if bound is not None else -np.inf
        for base in range(first, min(first + UNROLL * 32, o1), 32):
            own = lk[k - 1] if len(lk) == k else -np.inf
            lanes = [ln for ln in range(32) if base + ln < o1 and keys[base + ln] > own and keys[base + ln] >= shared]
            for ln in lanes:
                _insert(lk, lo, k, keys[base + ln], base + ln)
        if bound is not None and len(lk) == k:
            bound[0] = max(bound[0], _ord(lk[k - 1]))
    return lk, lo


def k7_line(degs, workers=SLICE_WARPS, min_piece=MIN_PIECE):
    """The long rows' line: (units P, piece Lu, warps G) from the long
    rows' degrees in row order (``k7_scan_long``)."""
    P = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    U = int(P[-1])
    piece = max(min_piece, -(-U // workers), -(-max(degs) // (MAX_PIECES - 1)))
    return P, piece, -(-U // piece)


def model_k7_topk(indptr, indices, probs, seeds, keys, k, workers=SLICE_WARPS, min_piece=MIN_PIECE,
                  reverse=False):
    """K7 without replacement; ``reverse`` runs the slice warps last to
    first (the card runs them in any order: only the shared bound sees it)."""
    n, E = len(indptr) - 1, len(indices)
    ids = np.full((len(seeds), k), INVALID, np.int32)
    mask = np.zeros((len(seeds), k), bool)

    def write(b, start, offs):
        for j, o in enumerate(offs):
            ids[b, j] = indices[min(start + o, E - 1)]
            mask[b, j] = True

    split = n > 0 and int(np.diff(indptr).max()) > SHORT_ROW  # the graph's max_degree
    long = []  # (b, start, deg) in row order
    for b, seed in enumerate(seeds):
        start, deg, _ = _extent(indptr, seed, n)
        if split and deg > SHORT_ROW:
            long.append((b, start, deg))
            continue
        write(b, start, _topk_range(_row_keys(start, deg, keys[b], probs, E), 0, deg, k)[1])
    if not long:
        return ids, mask
    P, piece, G = k7_line([d for _, _, d in long], workers, min_piece)
    row_keys = [_row_keys(start, deg, keys[b], probs, E) for b, start, deg in long]
    bounds = [[ORD_NEG_INF] for _ in long]
    slots = {}  # (warp, 0 | 1) -> (long row, [(key, offset)] descending)
    for g in (range(G - 1, -1, -1) if reverse else range(G)):
        s, e = g * piece, min(g * piece + piece, int(P[-1]))
        j0 = int(np.searchsorted(P, s, side="right")) - 1
        for j in range(j0, len(long)):
            if P[j] >= e:
                break
            b, start, deg = long[j]
            o0, o1 = max(s - P[j], 0), min(e, P[j + 1]) - P[j]
            whole = P[j] >= s and P[j + 1] <= e
            lk, lo = _topk_range(row_keys[j], o0, o1, k, None if whole else bounds[j])
            if whole:
                write(b, start, lo)
            else:
                slots[(g, 0 if j == j0 else 1)] = (j, list(zip(lk, lo)))
    for g in range(G):  # k7_merge_kernel: the warp of a split row's first edge
        h0, h1 = slots.get((g, 0)), slots.get((g, 1))
        if h0 is not None and P[h0[0]] == g * piece:
            j, first = h0[0], (g, 0)
        elif h1 is not None:
            j, first = h1[0], (g, 1)
        else:
            continue
        z = (int(P[j + 1]) - 1) // piece
        assert z - g + 1 <= MAX_PIECES
        lists = [slots[first][1]] + [slots[(q, 0)][1] for q in range(g + 1, z + 1)]
        assert all(slots[(q, 0)][0] == j for q in range(g + 1, z + 1))
        heads, picks = [0] * len(lists), []
        for _ in range(k):
            live = [(_pack(*lst[h]), i) for i, (lst, h) in enumerate(zip(lists, heads)) if h < len(lst)]
            if not live:
                break
            best, i = max(live)
            picks.append(lists[i][heads[i]][1])
            heads[i] += 1
        write(long[j][0], long[j][1], picks)
    return ids, mask


def _chunk_sums(w, tail_zeros):
    """Each 256-edge chunk's weights summed from 0 in row order; with
    ``tail_zeros`` the last chunk's missing edges are added as 0 (the long
    rows' tile fold), which changes no sum."""
    out = []
    for c0 in range(0, len(w), CHUNK):
        ct = F32(0)
        for x in w[c0:c0 + CHUNK]:
            ct = F32(ct + x)
        for _ in range(CHUNK - len(w[c0:c0 + CHUNK]) if tail_zeros else 0):
            ct = F32(ct + F32(0))
        out.append(ct)
    return out


def model_k7_cdf(indptr, indices, probs, seeds, keys, k):
    n, E = len(indptr) - 1, len(indices)
    ids = np.full((len(seeds), k), INVALID, np.int32)
    mask = np.zeros((len(seeds), k), bool)
    split = n > 0 and int(np.diff(indptr).max()) > SHORT_ROW
    for b, seed in enumerate(seeds):
        start, deg, valid = _extent(indptr, seed, n)
        w = probs[start:start + deg]
        cts = _chunk_sums(w, tail_zeros=split and deg > SHORT_ROW)
        total, befores = F32(0), []
        for ct in cts:
            befores.append(total)
            total = F32(total + ct)
        for t in range(k):
            target = F32(_uniform(keys[b, t]) * total)
            found, pick = False, 0
            for c, (ct, before) in enumerate(zip(cts, befores)):
                local = F32(target - before)
                if local >= 0 and ct > local:  # the first such chunk; walk it alone
                    cs = F32(0)
                    for i in range(c * CHUNK, min(deg, c * CHUNK + CHUNK)):
                        cs = F32(cs + w[i])
                        if cs > local:
                            found, pick = True, i
                            break
                    break
            if valid and total > 0 and found:
                ids[b, t] = indices[min(start + pick, E - 1)]
                mask[b, t] = True
    return ids, mask


def _alias_draw(b0, b1, deg, start, ap, ai, E):
    j = int(b0) % max(deg, 1)
    pos = min(start + j, E - 1)
    return j if _uniform(b1) < ap[pos] else int(ai[pos])


# csrc/sampling.cu: DG_K8_REG_MAX_K (k up to this keeps a long row's picks in
# registers), k8_group, k8_set_log, nth_set and K8's set
K8_REG_MAX_K = 32


def _k8_group(k, replace=False):
    return (8 if k <= 8 else (16 if k <= 16 else 32)) if replace else 32


def _k8_set_log(k, reg_max_k=K8_REG_MAX_K):
    if k <= reg_max_k:
        return 0
    log = 1
    while (1 << log) < 2 * k:
        log += 1
    return log


def _popc(m):
    return bin(m).count("1")


def _nth_set(m, n):
    """The position of the n-th set bit of m (from 0), by the kernel's
    binary search over popcounts."""
    p = 0
    for w in (16, 8, 4, 2, 1):
        if _popc(m & ((1 << (p + w)) - 1)) <= n:
            p += w
    return p


class _K8Set:
    """K8's open-addressed set: 2^log slots, linear probing from
    ``(d * golden) >> (32 - log)``, values as uint32."""

    def __init__(self, log):
        self.log, self.slots, self.probes = log, [None] * (1 << log), 0

    def _walk(self, d):
        i = ((d & 0xFFFFFFFF) * 0x9E3779B9 & 0xFFFFFFFF) >> (32 - self.log)
        while True:
            self.probes += 1
            yield i
            i = (i + 1) & ((1 << self.log) - 1)

    def has(self, d):
        for i in self._walk(d):
            if self.slots[i] == d & 0xFFFFFFFF:
                return True
            if self.slots[i] is None:
                return False

    def add(self, d):
        for i in self._walk(d):
            if self.slots[i] is None:
                self.slots[i] = d & 0xFFFFFFFF
                return


def model_k8(indptr, indices, probs, ap, ai, seeds, bits, gkeys, k, replace, reg_max_k=K8_REG_MAX_K,
             trace=None):
    """K8 as the kernel computes it: a group of G lanes a row, at lanes
    [base, base + G) of its warp, every mask in the warp's lane bits.  A
    long row reads its draws in rounds of min(G, T - t) and stops after
    the round that holds its k-th first occurrence.  ``trace`` (a dict) collects each row's
    draw indices read (``reads``), the round firsts an earlier round had
    kept (``cross_round``), the duplicates within a round (``in_round``),
    the rounds, and the set's probes."""
    n, E = len(indptr) - 1, len(indices)
    B = len(seeds)
    G = _k8_group(k, replace)
    log = _k8_set_log(k, reg_max_k)
    ids = np.full((B, k), INVALID, np.int32)
    mask = np.zeros((B, k), bool)
    shortfall = 0
    tr = trace if trace is not None else {}
    for key_ in ("reads", "rounds"):
        tr.setdefault(key_, {})
    for key_ in ("cross_round", "in_round", "probes"):
        tr.setdefault(key_, 0)
    for b, seed in enumerate(seeds):
        base = (b % (32 // G)) * G  # the group's first lane in its warp
        lanes = range(base, base + G)
        start, deg, valid = _extent(indptr, seed, n)
        T, D = (k, 2 * k) if replace else (4 * k, 2 * k)
        reads = tr["reads"].setdefault(b, [])

        def draw(t):
            reads.append(t)
            return _alias_draw(bits[0, b, t], bits[1, b, t], deg, start, ap, ai, E)

        if replace:
            if valid and deg > 0:
                for t in range(k):
                    ids[b, t], mask[b, t] = indices[min(start + draw(t), E - 1)], True
            continue
        if deg == 0:
            continue
        if deg <= D:
            sk = [(_gumbel(gkeys[b, o], probs[min(start + o, E - 1)])
                   if o < deg and probs[min(start + o, E - 1)] > 0 else -np.inf) for o in range(D)]
            for o in range(D):
                rank = sum(1 for j in range(D) if sk[j] > sk[o] or (sk[j] == sk[o] and j < o))
                if rank < k and sk[o] > -np.inf:
                    ids[b, rank], mask[b, rank] = indices[min(start + o, E - 1)], True
            continue
        kept = [0] * 32  # the warp's registers: lane base + i holds pick i
        kset, picks = (_K8Set(log), [0] * k) if log else (None, None)
        got = t0 = rounds = 0
        while True:
            cnt = min(G, T - t0)
            act = {lane: lane - base < cnt for lane in lanes}
            d = {lane: draw(t0 + lane - base) if act[lane] else -1 for lane in lanes}
            actm = sum(1 << lane for lane in lanes if act[lane])
            first = {}
            for lane in lanes:  # __match_any_sync, then the lowest active lane
                same = sum(1 << x for x in lanes if d[x] == d[lane]) & actm
                first[lane] = act[lane] and (same & ((1 << lane) - 1)) == 0
            tr["in_round"] += sum(act.values()) - sum(first.values())
            before = sum(first.values())
            if log == 0:
                for i in range(got):  # a shuffle from lane base + i
                    e = kept[base + i]
                    for lane in lanes:
                        first[lane] = first[lane] and e != d[lane]
            else:
                for lane in lanes:
                    if first[lane]:
                        first[lane] = not kset.has(d[lane])
            tr["cross_round"] += before - sum(first.values())
            bal = sum(1 << lane for lane in lanes if first[lane])
            keep = min(_popc(bal), k - got)  # the new firsts of rank < k
            if log == 0:
                for lane in lanes:
                    q = lane - base - got
                    if 0 <= q < keep:
                        kept[lane] = d[_nth_set(bal, q)]
            else:
                for lane in lanes:
                    rank = got + _popc(bal & ((1 << lane) - 1))
                    if first[lane] and rank < k:
                        picks[rank] = d[lane]
                        kset.add(d[lane])
            got += keep
            t0 += cnt
            rounds += 1
            if not (got < k and t0 < T):
                break
        assert got <= k
        for j in range(got):
            off = kept[base + j] if log == 0 else picks[j]
            ids[b, j], mask[b, j] = indices[min(start + off, E - 1)], True
        shortfall += k - got
        tr["rounds"][b] = rounds
        tr["probes"] += kset.probes if kset else 0
    return ids, mask, shortfall


def _plain_draws(indptr, ap, ai, seeds, bits, k, E):
    """Each long row's index of its k-th first occurrence among its 4k
    draws in order (T - 1 when it falls short), and its distinct draws."""
    n = len(indptr) - 1
    out = {}
    for b, seed in enumerate(seeds):
        start, deg, valid = _extent(indptr, seed, n)
        if not valid or deg <= 2 * k:
            continue
        seq = [_alias_draw(bits[0, b, t], bits[1, b, t], deg, start, ap, ai, E) for t in range(4 * k)]
        seen, last = set(), 4 * k - 1
        for t, x in enumerate(seq):
            if x not in seen:
                seen.add(x)
                if len(seen) == k:
                    last = t
                    break
        out[b] = (last, len(set(seq)))
    return out


# ---- the inputs: rows at the kernels' edges ----------------------------------


def _edge_graph(k, seed=0, indptr_dtype=np.int32):
    """Rows of degree 0, 1, k, 2k, 2k + 1, 31, 32, 33, 300 (over chunks of
    256), an all-zero-weight row, a row of equal weights (ties), 1025 and
    3000 (above K7's short-row limit: cut into slices across warps), then
    random rows; about a tenth of the weights 0."""
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
    assert mask[11].all() and mask[12].all()  # the long rows, cut into slices


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


def _slice_graph(case, seed):
    """A graph for one case of K7's cut (SHORT_ROW = MIN_PIECE = 1024 edges),
    with random rows beside it, a tenth of the weights 0 and padded seeds:
    * ``limit``: rows of 1023, 1024 and 1025 edges (each side of the short-row
      limit and of a range's length) and 2047-2049;
    * ``many_slices``: a row of 40,000 edges, over 39 ranges;
    * ``repeated_hub``: a 6,000-edge row whose node is 8 of the seeds;
    * ``zero_slice``: a 5,000-edge row whose edges [1024, 3072) weigh 0,
      two whole ranges of zero weights."""
    rng = np.random.default_rng(seed)
    head = {"limit": [1023, 1024, 1025, 2047, 2048, 2049], "many_slices": [40_000, 1500],
            "repeated_hub": [6000, 1100], "zero_slice": [5000, 1200]}[case]
    degs = head + list(rng.integers(0, 60, 30))
    n = len(degs) + 3
    dst = np.repeat(np.arange(len(degs)), degs)
    w = np.abs(rng.standard_normal(len(dst))).astype(np.float32)
    w[rng.random(len(w)) < 0.1] = 0
    if case == "zero_slice":
        w[1024:3072] = 0
    indptr = np.concatenate([[0], np.cumsum(degs), np.full(3, len(dst))])
    hg = tgraph.HostGraph(indptr=indptr, indices=rng.integers(0, n, len(dst)).astype(np.int32), probs=w)
    seeds = np.concatenate([np.arange(len(head)), rng.integers(0, n, 20)])
    if case == "repeated_hub":
        seeds = np.concatenate([seeds, np.zeros(8, np.int64)])
    seeds = rng.permutation(seeds).astype(np.int32)
    seeds[::9] = INVALID
    if case == "repeated_hub":
        seeds[-1] = 0
    return hg, seeds


@pytest.mark.parametrize("case", ["limit", "many_slices", "repeated_hub", "zero_slice"])
@pytest.mark.parametrize("replace", [False, True])
def test_k7_slices_model_equals_plain_and_jax(case, replace):
    """K7's model at the cut's edges equals the plain version and, on
    injected keys, JAX's sample_biased; without replacement also when the
    slice warps run last to first and when the ranges are 16 times shorter
    (every long row in many pieces, up to MAX_PIECES)."""
    k = 7
    hg, seeds = _slice_graph(case, 7 + replace)
    key = jax.random.key(len(case) + 10 * replace)
    B = len(seeds)
    keys = torch.from_numpy(np.asarray(jprng.random_keys(key, (B, k) if replace else (B,))).astype(np.int64))
    got = tsampling.sample_biased_plain(hg.to_device("cpu"), torch.from_numpy(seeds), k, replace, keys)
    model = model_k7_cdf if replace else model_k7_topk
    ids, mask = model(*_np(hg), seeds, keys.numpy(), k)
    np.testing.assert_array_equal(ids, got.ids.numpy())
    np.testing.assert_array_equal(mask, got.mask.numpy())
    if not replace:
        for kw in ({"reverse": True}, {"min_piece": 64}, {"min_piece": 64, "reverse": True}):
            again = model_k7_topk(*_np(hg), seeds, keys.numpy(), k, **kw)
            np.testing.assert_array_equal(again[0], ids)
            np.testing.assert_array_equal(again[1], mask)
    jg = jgraph.HostGraph(indptr=hg.indptr, indices=hg.indices, probs=hg.probs).to_device()
    want = jsampling.sample_biased(jg, seeds, k, replace, key)
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    assert mask.any()
    if case == "repeated_hub":  # the hub's rows: one node, different row keys
        hub = np.flatnonzero(seeds == 0)
        assert len(hub) >= 8 and mask[hub].all() and len({tuple(r) for r in ids[hub]}) > 1


def test_k7_slices_cover_the_cut():
    """The line's ranges: at the bench's scale a range holds about U / W
    edges; a long row is cut into at most MAX_PIECES pieces whatever W."""
    P, piece, G = k7_line([226_746] * 64)
    assert piece == -(-64 * 226_746 // SLICE_WARPS) and G <= SLICE_WARPS
    P, piece, G = k7_line([226_746], workers=10**6, min_piece=1)
    assert piece * (MAX_PIECES - 1) >= 226_746 and G <= MAX_PIECES


def _collision(deg, lo_end):
    """A JAX key whose row key (``random_keys(key, (1,))``, as JAX's
    sample_biased draws it for one seed) gives a row of ``deg`` edges two
    offsets i < lo_end <= j with the same 24 uniform bits: the key, the row
    key and the pair."""
    off = np.arange(deg, dtype=np.uint32)
    for s in range(400):
        jkey = jax.random.key(s)
        rk = int(np.asarray(jprng.random_keys(jkey, (1,)))[0])
        u24 = _mix32_np(np.uint32(rk) ^ _mix32_np(off)) >> np.uint32(8)
        first = {}
        for i in range(lo_end):
            first.setdefault(int(u24[i]), i)
        for j in range(lo_end, deg):
            if int(u24[j]) in first:
                return jkey, rk, first[int(u24[j])], j
    raise AssertionError("no collision")


@pytest.mark.parametrize("k", [1, 2])
def test_k7_equal_keys_across_a_slice_boundary_take_the_lower_offset(k):
    """Two edges of one long row, on the two sides of the first range
    boundary (offset 1024), draw the same uniform and carry the same
    weight, far above the others': their keys are equal, and the lower
    offset comes first, in the model (whichever slice warp runs first),
    the plain version and JAX, all on JAX's row key."""
    deg = 3000
    jkey, rk, i, j = _collision(deg, MIN_PIECE)
    w = np.full(deg, 1e-30, np.float32)
    w[[i, j]] = 1.0
    hg = tgraph.HostGraph(indptr=np.array([0, deg, deg], np.int64),
                          indices=(np.arange(deg) % 2).astype(np.int32) + 5 * (np.arange(deg) == j), probs=w)
    seeds = np.zeros(1, np.int32)
    keys = np.array([rk], np.int64)
    assert _row_keys(0, deg, rk, w, deg)[i] == _row_keys(0, deg, rk, w, deg)[j]
    got = tsampling.sample_biased_plain(hg.to_device("cpu"), torch.from_numpy(seeds), k, False, torch.from_numpy(keys))
    want = [hg.indices[i], hg.indices[j]][:k]
    assert got.ids.numpy()[0].tolist() == want
    for reverse in (False, True):
        ids, mask = model_k7_topk(*_np(hg), seeds, keys, k, reverse=reverse)
        assert ids[0].tolist() == want and mask.all()
    jg = jgraph.HostGraph(indptr=hg.indptr, indices=hg.indices, probs=hg.probs).to_device()
    jout = jsampling.sample_biased(jg, seeds, k, False, jkey)
    assert np.asarray(jout.ids)[0].tolist() == want and np.asarray(jout.mask).all()


def _sort_desc(v):
    """csrc/sampling.cu sort_desc on 32 lanes: the bitonic network as written
    (lane ^ stride the partner, keep_max by the two lane bits)."""
    v = list(v)
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride > 0:
            o = [v[ln ^ stride] for ln in range(32)]
            v = [max(a, b) if ((ln & size) == 0) == ((ln & stride) == 0) else min(a, b)
                 for ln, (a, b) in enumerate(zip(v, o))]
            stride >>= 1
        size <<= 1
    return v


def _merge_sorted(a, b):
    """csrc/sampling.cu merge_sorted: a against b reversed, then five
    half-cleaner stages."""
    v = [max(x, b[31 - ln]) for ln, x in enumerate(a)]
    stride = 16
    while stride > 0:
        o = [v[ln ^ stride] for ln in range(32)]
        v = [max(x, y) if (ln & stride) == 0 else min(x, y) for ln, (x, y) in enumerate(zip(v, o))]
        stride >>= 1
    return v


@pytest.mark.parametrize("filled", [0, 5, 32])
def test_k7_batch_insert_sorts_and_merges(filled):
    """The register list's batch insert: sorting a step's 32 packed
    candidates (0 where a lane has none) across the lanes and merging them
    into the sorted list keeps the 32 largest of both, descending, as
    inserting them one by one does."""
    rng = np.random.default_rng(filled)
    for _ in range(20):
        keys = -np.abs(rng.standard_normal(64)).astype(np.float32)
        offs = rng.permutation(1000)[:64]
        packed = [_pack(x, int(o)) for x, o in zip(keys, offs)]
        lst = sorted(packed[:filled], reverse=True) + [0] * (32 - filled)
        cand = [c if rng.random() < 0.7 else 0 for c in packed[32:]]
        assert _sort_desc(cand) == sorted(cand, reverse=True)
        assert _merge_sorted(lst, _sort_desc(cand)) == sorted(lst + cand, reverse=True)[:32]


def test_k7_merge_packing_is_lax_top_k_order():
    """The merge's 64-bit entries order as ``beats`` does (larger key, then
    lower offset), equal keys included, and the shared bound's order bits
    round-trip every key, -inf too."""
    rng = np.random.default_rng(3)
    keys = np.concatenate([-np.abs(rng.standard_normal(300)).astype(np.float32) * 10,
                           np.full(20, -0.5, np.float32), [F32(-np.inf), F32(-0.0), F32(-1e-38)]])
    offs = rng.permutation(len(keys))
    by_pack = sorted(range(len(keys)), key=lambda i: _pack(keys[i], offs[i]), reverse=True)
    by_beats = sorted(range(len(keys)), key=lambda i: (-float(keys[i]), offs[i]))
    assert by_pack == by_beats
    for x in keys:
        assert _from_ord(_ord(x)) == x
    assert _ord(F32(-np.inf)) == ORD_NEG_INF and all(_pack(x, o) > 0 for x, o in zip(keys, offs))


def _jax_alias_keys(key, B, k, replace):
    """The keys JAX's ``sample_biased_alias`` draws from ``key``, as the
    port's plain version takes them injected."""
    if replace:
        return torch.from_numpy(np.asarray(jprng.random_keys(key, (2, B, k))).astype(np.int64))
    bits = np.asarray(jprng.random_keys(key, (2, B, 4 * k))).astype(np.int64)
    gum = np.asarray(jprng.random_keys(jax.random.fold_in(key, 1), (B, 2 * k))).astype(np.int64)
    return torch.from_numpy(bits), torch.from_numpy(gum)


def _k8_against_plain_and_jax(hg, seeds, k, replace, key, reg_max_k=K8_REG_MAX_K, trace=None):
    """The model, the plain version and JAX's ``sample_biased_alias`` on one
    set of JAX keys: ids, mask and the shortfall equal."""
    g = hg.to_device("cpu", with_alias=True)
    akey = _jax_alias_keys(key, len(seeds), k, replace)
    got = tsampling.sample_biased_alias_plain(g, torch.from_numpy(seeds), k, replace, akey)
    bits, gk = (akey, akey) if replace else akey
    ids, mask, short = model_k8(*_np(hg), g.alias_prob.numpy(), g.alias_idx.numpy(), seeds, bits.numpy(),
                                gk.numpy(), k, replace, reg_max_k, trace)
    np.testing.assert_array_equal(ids, got.ids.numpy())
    np.testing.assert_array_equal(mask, got.mask.numpy())
    assert short == int(got.overflow)
    jg = jgraph.HostGraph(indptr=hg.indptr, indices=hg.indices, probs=hg.probs).to_device(with_alias=True)
    want = jsampling.sample_biased_alias(jg, seeds, k, replace, key)
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    assert short == int(want.overflow)
    return g, akey, ids, mask, short


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("replace", [False, True])
def test_k8_model_equals_plain(replace, k):
    """The model at the edge rows (degrees 0, 1, k, 2k, 2k + 1, 31-33, 300,
    1025, 3000, random), on JAX's keys: equal to the plain version and to
    JAX's sampler."""
    hg, seeds = _edge_graph(k, 100 + k)
    _k8_against_plain_and_jax(hg, seeds, k, replace, jax.random.key(100 + k))


@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("reg_max_k", [K8_REG_MAX_K, 0])
@pytest.mark.parametrize("k", [5, 15, 40])
def test_k8_model_both_lists_equal_plain(k, reg_max_k, indptr_dtype):
    """The register list (k <= 32) and the shared set (k = 40 always; every
    k with DG_K8_REG_MAX_K=0, bench_k8's ``shared`` variant) give the plain
    version's picks; the set is probed about once a lookup or insert."""
    hg, seeds = _edge_graph(k, 200 + k, indptr_dtype)
    trace = {}
    _k8_against_plain_and_jax(hg, seeds, k, False, jax.random.key(200 + k), reg_max_k, trace)
    if _k8_set_log(k, reg_max_k):
        lookups = sum(len(v) for v in trace["reads"].values())  # at most one lookup and one insert a draw
        assert 0 < trace["probes"] < 4 * lookups
    else:
        assert trace["probes"] == 0


@pytest.mark.parametrize("k", [3, 15, 40])
def test_k8_model_starts_no_round_after_the_kth_first_occurrence(k):
    """A long row reads its draws 0, 1, ... in order, in rounds of G, and
    starts no round after the one that holds its k-th first occurrence: it
    reads fewer than G draws past it; a row that never reaches k reads all
    4k."""
    hg, seeds = _edge_graph(k, 300 + k)
    trace = {}
    g, akey, *_ = _k8_against_plain_and_jax(hg, seeds, k, False, jax.random.key(300 + k), trace=trace)
    draws = _plain_draws(hg.indptr.astype(np.int64), g.alias_prob.numpy(), g.alias_idx.numpy(), seeds,
                         akey[0].numpy(), k, hg.num_edges)
    assert draws
    G = _k8_group(k)
    for b, (last, distinct) in draws.items():
        end = min(-(-(last + 1) // G) * G, 4 * k)
        assert trace["reads"][b] == list(range(end)) and end - (last + 1) < G, b
        assert (last == 4 * k - 1) or distinct >= k
    # rows that need fewer draws than a full pass read fewer
    assert any(last + 1 < 4 * k for last, _ in draws.values())
    for b in set(range(len(seeds))) - set(draws):  # short rows and padded seeds take no draw
        assert trace["reads"][b] == []


def test_k8_model_counts_a_shortfall():
    """A long row with 2 drawable edges and k = 4: every call falls short
    by 2, in the model, the plain version and JAX alike, and reads all 16
    draws."""
    indptr = np.array([0, 12], np.int64)
    w = np.zeros(12, np.float32)
    w[[3, 7]] = 1.0
    hg = tgraph.HostGraph(indptr=indptr, indices=np.arange(12, dtype=np.int32) + 5, probs=w)
    seeds = np.zeros(6, np.int32)
    trace = {}
    _, _, ids, mask, short = _k8_against_plain_and_jax(hg, seeds, 4, False, jax.random.key(0), trace=trace)
    assert short == 6 * 2
    assert set(ids[mask].tolist()) == {8, 12}
    assert all(trace["reads"][b] == list(range(16)) for b in range(6))
    assert all(trace["rounds"][b] == -(-16 // _k8_group(4)) for b in range(6))


def test_k8_model_drops_duplicates_across_rounds():
    """Rows of 60 edges, most of the weight on 5 of them, k = 10: draws
    repeat within a round and across rounds (a value kept in round 1 drawn
    again in round 2), and the picks still equal the plain version's."""
    rng = np.random.default_rng(7)
    degs = [60] * 16
    w = np.full(sum(degs), 0.01, np.float32)
    for r in range(len(degs)):
        w[60 * r + rng.choice(60, 5, replace=False)] = 1.0
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    hg = tgraph.HostGraph(indptr=indptr, indices=rng.integers(0, 80, sum(degs)).astype(np.int32), probs=w)
    seeds = np.repeat(np.arange(len(degs)), 4).astype(np.int32)
    trace = {}
    _k8_against_plain_and_jax(hg, seeds, 10, False, jax.random.key(7), trace=trace)
    assert trace["cross_round"] > 0 and trace["in_round"] > 0
    assert max(trace["rounds"].values()) >= 2


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("k", [5, 10, 40])
def test_k8_model_warps_of_mixed_rows(k, replace):
    """Group boundaries: with replacement a warp holds 32 / G rows (4 at
    k = 5, 2 at k = 10), and here of different kinds (a long row, a short
    row, a padded seed, a zero-degree row, a long row that falls short),
    in every rotation, so each kind sits at each group of a warp; the
    warp-lane masks keep the groups apart.  Without replacement a row is a
    warp, and the same seeds are held to the plain version."""
    rng = np.random.default_rng(k)
    degs = [4 * k + 9, 2 * k, 0, 3 * k, 2 * k + 1]  # long, short, empty, long (falls short), long
    w = np.abs(rng.standard_normal(sum(degs))).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    w[indptr[3]:indptr[4]] = 0
    w[indptr[3]] = 1.0  # one drawable edge: short of k
    hg = tgraph.HostGraph(indptr=indptr, indices=rng.integers(0, 60, sum(degs)).astype(np.int32), probs=w)
    kinds = [0, 1, INVALID, 2, 3, 4]
    per_warp = 32 // _k8_group(k, replace)
    seeds = np.array([kinds[(i + r) % len(kinds)] for r in range(len(kinds)) for i in range(max(per_warp, 2))],
                     np.int32)
    _, _, ids, mask, short = _k8_against_plain_and_jax(hg, seeds, k, replace, jax.random.key(k))
    assert short == (0 if replace else (k - 1) * int((seeds == 3).sum()))  # the row with one edge keeps 1
    assert not mask[seeds == INVALID].any() and not mask[seeds == 2].any()
    if replace and k <= 16:
        assert per_warp > 1


def test_k8_nth_set_finds_each_set_bit():
    """nth_set against numpy's positions of the set bits, on random masks
    and the edge ones."""
    rng = np.random.default_rng(0)
    masks = [0xFFFFFFFF, 1, 0x80000000, 0x80000001, 0xFF00, 0xFF000000] \
        + [int(x) for x in rng.integers(1, 2**32, 300, dtype=np.uint64)]
    for m in masks:
        pos = [i for i in range(32) if m >> i & 1]
        assert [_nth_set(m, q) for q in range(len(pos))] == pos


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


@pytest.mark.parametrize("max_degree", [1024, 1025])
@pytest.mark.parametrize("replace", [False, True])
def test_k7_wrapper_passes_a_workspace_sized_from_the_host(monkeypatch, replace, max_degree):
    """Past the device checks (patched out: no card), sample_biased asks K7
    for its workspace from B, k and graph.max_degree alone, takes it from
    torch's allocator (none when the kernel needs none: no row above the
    short-row limit), passes it with the graph's max_degree on the seeds'
    stream, and counts one launch a call."""
    import dataclasses

    hg, _ = _edge_graph(3)
    g = dataclasses.replace(_meta_graph(hg, alias=False), max_degree=max_degree)
    need = 0 if max_degree <= SHORT_ROW else 4096
    calls = {}

    class Lib:
        def dg_sample_biased_workspace(self, B, k, md, rep, out):
            calls["workspace"] = (B, k, md, rep)
            out._obj.value = need
            return 0

        def dg_sample_biased(self, *args):
            calls["run"] = args
            return 0

    monkeypatch.setattr(tsampling, "_lib", Lib)
    monkeypatch.setattr(tsampling, "_check_weighted", lambda *a, **kw: None)
    monkeypatch.setattr(tsampling, "stream_of", lambda t: 7)
    seeds = torch.empty(10, dtype=torch.int32, device="meta")
    keys = torch.zeros((10, 3) if replace else (10,), dtype=torch.int64).to("meta")
    before = tsampling.sample_biased.launches
    out = tsampling.sample_biased(g, seeds, 3, replace, keys)
    assert calls["workspace"] == (10, 3, max_degree, int(replace))
    assert calls["run"][8:] == (10, 3, g.num_nodes, g.num_edges, int(replace), max_degree,
                                None if need == 0 else 0, need, 7)
    assert tsampling.sample_biased.launches == before + 1 and out.ids.shape == (10, 3)
    tsampling.sample_biased.launches = before


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


def test_k7_list_variants_build_libraries_of_their_own(monkeypatch):
    """bench_k7's variants: each -D set is a library of its own, and the
    default build is the one the wrappers load."""
    from dist_gnn_tpu_torch.scripts import bench_k7

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")

    src = (build.CSRC_DIR / "sampling.cu").read_text()
    paths = {build._lib_path("sampling", d) for d in bench_k7.VARIANTS.values()}
    assert len(paths) == len(bench_k7.VARIANTS) and build._lib_path("sampling") in paths
    assert bench_k7.VARIANTS["reg_batch"] == ()
    for defines in bench_k7.VARIANTS.values():
        for d in defines:
            assert f"#ifndef {d[2:].split('=')[0]}" in src
        cmd = build._command(build.CSRC_DIR / "sampling.cu", Path("out.so"), defines)
        assert cmd[cmd.index("-o") - len(defines):cmd.index("-o")] == list(defines)


def test_k8_variants_build_libraries_of_their_own(monkeypatch):
    """bench_k8's variants: each -D set names a knob of csrc/sampling.cu and
    is a library of its own, and the default build is the one the wrappers
    load."""
    from dist_gnn_tpu_torch.scripts import bench_k8

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    src = (build.CSRC_DIR / "sampling.cu").read_text()
    paths = {build._lib_path("sampling", d) for d in bench_k8.VARIANTS.values()}
    assert len(paths) == len(bench_k8.VARIANTS) and build._lib_path("sampling") in paths
    assert bench_k8.VARIANTS["default"] == ()
    for defines in bench_k8.VARIANTS.values():
        for d in defines:
            name, value = d[2:].split("=")
            assert f"#ifndef {name}" in src and f"#define {name} {value}" not in src


@pytest.mark.parametrize("k", [3, 15])
def test_k8_bound_counts_the_draws_the_kernel_reads(k):
    """bench_k8.k8_bytes (chip_smoke's K8 bound) charges a long row the
    draws up to its k-th first occurrence (the model, in rounds of G,
    reads fewer than G more), and fewer bytes than charging all 4k; with
    replacement every draw is needed."""
    from dist_gnn_tpu_torch.scripts import bench_k8

    hg, seeds = _edge_graph(k, 400 + k)
    trace = {}
    g, akey, *_ = _k8_against_plain_and_jax(hg, seeds, k, False, jax.random.key(400 + k), trace=trace)
    st = torch.from_numpy(seeds)
    got = bench_k8.k8_bytes(g, st, k, False, akey)
    draws = _plain_draws(hg.indptr.astype(np.int64), g.alias_prob.numpy(), g.alias_idx.numpy(), seeds,
                         akey[0].numpy(), k, hg.num_edges)
    assert got["drawn_rows"] == len(draws) and got["draws_all"] == 4 * k * len(draws)
    assert got["draws_needed"] == sum(last + 1 for last, _ in draws.values()) < got["draws_all"]
    assert all(0 <= len(trace["reads"][b]) - (last + 1) < _k8_group(k) for b, (last, _) in draws.items())
    assert 0 < got["bytes"] < got["bytes_all_draws"]
    rkey = _jax_alias_keys(jax.random.key(401 + k), len(seeds), k, True)
    rep = bench_k8.k8_bytes(g, st, k, True, rkey)
    assert rep["draws_needed"] == rep["draws_all"] and rep["bytes"] == rep["bytes_all_draws"]


def test_k8_needed_draws_stop_at_the_kth_first_occurrence():
    from dist_gnn_tpu_torch.scripts import bench_k8

    d = torch.tensor([[4, 4, 2, 4, 7, 1, 9, 9], [1, 1, 1, 1, 1, 1, 2, 1], [3, 5, 6, 8, 0, 0, 0, 0]])
    need = bench_k8.needed_draws(d, 3)
    assert need.sum(1).tolist() == [5, 8, 3]  # 4, 2, 7 at t = 0, 2, 4; a row short of 3; 3, 5, 6


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
