"""Rowwise neighbour sampling with static padded shapes.

Counterpart of ``dist_gnn_tpu/ops/sampling.py``:

* uniform without replacement: a keyed Feistel permutation of [0, degree)
  evaluated at slots 0..k-1 (a row of degree <= k takes all of its
  neighbours); with replacement, k independent ``bits % degree`` draws;
* weighted (``graph.probs``), :func:`sample_biased`: without replacement
  the exact Gumbel-key (A-Res) top-k over the whole row, with replacement
  a chunked inverse CDF;
* weighted from Walker alias tables (``graph.alias_prob``/``alias_idx``),
  :func:`sample_biased_alias`: one O(1) draw per slot with replacement;
  without it, the exact Gumbel top-k on rows of degree <= 2k and the first
  k distinct of 4k draws on longer rows, whose shortfall is counted in
  ``overflow``.

Padded seeds (INVALID_ID) and zero-degree rows give fully masked rows;
masked slots hold INVALID_ID; a zero-weight edge is never drawn.  Only the
JAX package's exact elementwise fetch is ported: its window cascade
(``sample_biased_windowed``, the W1/W2 levels, R1/R2 budgets and
``alias_pack``) is a TPU gather layout whose every level is
A-Res-equivalent, so where JAX takes the windowed sampler the port takes
the alias sampler (:func:`sample_neighbors`).

Randomness is a pure function of uint32 keys (the shapes each sampler
names), and ``key`` is either a ``torch.Generator`` the keys are drawn
from, or the key tensors themselves, so a test can inject the JAX
package's ``prng.random_keys`` and require the same samples.

On the card each sampler makes one call a hop into ``csrc/sampling.cu``
(K6 ``dg_sample_uniform``, K7 ``dg_sample_biased``, K8
``dg_sample_biased_alias``, whose header notes what each replaces, what
bounds it and how its design meets that bound): one kernel for K6 and K8,
up to three for K7, in a workspace the wrapper takes from torch's
allocator.
Their plain PyTorch versions (``*_plain``) serve CPU tensors and only
them.  A CUDA tensor launches the kernel, or raises: there is no fallback.
Each wrapper's ``.launches`` counts its calls that launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Union

import torch

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph
from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.ops import prng
from dist_gnn_tpu_torch.kernels.launch import check_launch, require, stream_of

Key = Union[torch.Generator, torch.Tensor]


class SampledNeighbors(NamedTuple):
    ids: torch.Tensor  # [B, k] int32 global neighbour ids, INVALID_ID padded
    mask: torch.Tensor  # [B, k] bool
    # sampled slots masked because a draw budget fell short: the alias
    # sampler's shortfall (a 0-d int32 tensor on the seeds' device); 0 on
    # the exact paths
    overflow: Union[int, torch.Tensor] = 0


def draw_keys(key: Key, shape, device: torch.device) -> torch.Tensor:
    """The uint32 keys of one sampling call: drawn from a generator, or the
    injected tensor itself (checked for shape)."""
    if isinstance(key, torch.Generator):
        return prng.random_keys(key, shape, device)
    key = torch.as_tensor(key)
    if tuple(key.shape) != tuple(shape):
        raise ValueError(f"injected keys have shape {tuple(key.shape)}, need {tuple(shape)}")
    return key.to(device=device, dtype=torch.int64)


def _row_extents(graph: Graph, seeds: torch.Tensor):
    valid = seeds != INVALID_ID
    safe = torch.where(valid, seeds, 0).long()
    start = graph.indptr[safe].long()
    deg = (graph.indptr[safe + 1].long() - start).to(torch.int32)
    deg = torch.where(valid, deg, 0)
    return start, deg, valid


def _lib(defines: Sequence[str] = ()) -> ctypes.CDLL:
    lib = build.load("sampling", defines)
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.dg_sample_uniform.argtypes = [p, i32, p, p, p, p, p, i64, i32, i64, i64, i32, p]
        lib.dg_sample_uniform.restype = i32
        lib.dg_sample_biased.argtypes = [p, i32, p, p, p, p, p, p, i64, i32, i64, i64, i32, i64, p, i64, p]
        lib.dg_sample_biased.restype = i32
        lib.dg_sample_biased_workspace.argtypes = [i64, i32, i64, i32, ctypes.POINTER(ctypes.c_int64)]
        lib.dg_sample_biased_workspace.restype = i32
        lib.dg_sample_biased_alias.argtypes = [
            p, i32, p, p, p, p, p, p, p, p, p, p, i64, i32, i64, i64, i32, p,
        ]
        lib.dg_sample_biased_alias.restype = i32
        lib._argtypes_set = True
    return lib


def plain_positions(graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key):
    """The plain version's selection, op by op: ``(pos, mask)``, the [B, k]
    positions into ``graph.indices`` that the slots read (``start + sel``
    clamped into the edge list) and which slots are taken.  Keys are drawn
    as :func:`sample_uniform` draws them."""
    B = seeds.shape[0]
    dev = seeds.device
    start, deg, valid = _row_extents(graph, seeds)
    j = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k)

    if replace:
        bits = draw_keys(key, (B, k), dev)
        sel = prng.uniform_mod(bits, deg[:, None])
        mask = (valid & (deg > 0))[:, None].expand(B, k)
    else:
        row_key = draw_keys(key, (B,), dev)
        perm = prng.feistel_permutation(j, deg[:, None], row_key[:, None])
        sel = torch.where(deg[:, None] <= k, j, perm)
        mask = valid[:, None] & (j < torch.clamp(deg[:, None], max=k))
    pos = torch.clamp(start[:, None] + sel.long(), 0, max(graph.num_edges - 1, 0))
    return pos, mask


def sample_uniform_plain(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Plain version of K6 (what :func:`sample_uniform` runs for CPU
    tensors), op by op in PyTorch on any device."""
    if graph.num_edges == 0:  # every row is empty, a node-less graph's too
        B = seeds.shape[0]
        draw_keys(key, (B, k) if replace else (B,), seeds.device)  # drawn as on the card
        mask = torch.zeros((B, k), dtype=torch.bool, device=seeds.device)
        ids = torch.full((B, k), INVALID_ID, dtype=torch.int32, device=seeds.device)
        return SampledNeighbors(ids=ids, mask=mask)
    pos, mask = plain_positions(graph, seeds, k, replace, key)
    ids = torch.where(mask, graph.indices[pos], INVALID_ID)
    return SampledNeighbors(ids=ids, mask=mask.contiguous())


def _check_graph(graph: Graph, seeds: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the seeds and the graph suit K6: one CUDA
    device (compared by index: a CPU or meta tensor has index -1), int32
    seeds, an int32 or int64 ``indptr`` and int32 ``indices``, all
    contiguous and 1-D."""
    require(seeds.is_cuda, "seeds must lie on a CUDA device")
    index = seeds.get_device()
    require(
        graph.indptr.get_device() == index and graph.indices.get_device() == index,
        f"the graph must lie on the seeds' CUDA device {index}",
    )
    require(
        seeds.dtype == torch.int32 and seeds.dim() == 1 and seeds.is_contiguous(),
        "seeds must be a contiguous 1-D int32 tensor",
    )
    require(
        graph.indptr.dtype in (torch.int32, torch.int64) and graph.indptr.dim() == 1
        and graph.indptr.is_contiguous() and graph.indptr.shape[0] == graph.num_nodes + 1,
        "indptr must be a contiguous [N + 1] int32 or int64 tensor",
    )
    require(
        graph.indices.dtype == torch.int32 and graph.indices.is_contiguous()
        and graph.indices.shape == (graph.num_edges,),
        "indices must be a contiguous [E] int32 tensor",
    )


def sample_uniform(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Uniformly sample up to ``k`` in-neighbours per seed row — K6 on the
    card, one launch per call (plain version: :func:`sample_uniform_plain`).
    The keys are drawn (or checked) as the plain version draws them; an
    edgeless graph or an empty output is answered without a launch.  Ids
    and mask equal the plain version's bit for bit.

    Distinctness caveat (replace=False): picks come from a keyed Feistel
    permutation whose cycle-walk fallback breaks bijectivity with ~1e-3
    probability per element (``prng.feistel_permutation``), so a row can
    very rarely hold a duplicate neighbour.  The relabel dedups, so results
    stay correct; only the sampling statistics carry the ~0.1% noise.
    """
    if seeds.device.type == "cpu":
        return sample_uniform_plain(graph, seeds, k, replace, key)
    _check_graph(graph, seeds)
    B = seeds.shape[0]
    keys = draw_keys(key, (B, k) if replace else (B,), seeds.device).contiguous()
    if graph.num_edges == 0 or B * k == 0:
        return SampledNeighbors(
            ids=torch.full((B, k), INVALID_ID, dtype=torch.int32, device=seeds.device),
            mask=torch.zeros((B, k), dtype=torch.bool, device=seeds.device),
        )
    ids = seeds.new_empty((B, k))  # new_empty: no dtype and device to parse (PERF.md)
    mask = seeds.new_empty((B, k), dtype=torch.bool)
    rc = _lib().dg_sample_uniform(
        graph.indptr.data_ptr(), int(graph.indptr.dtype == torch.int64), graph.indices.data_ptr(),
        seeds.data_ptr(), keys.data_ptr(), ids.data_ptr(), mask.data_ptr(),
        B, k, graph.num_nodes, graph.num_edges, int(replace), stream_of(seeds),
    )
    check_launch(rc, "sample_uniform")
    sample_uniform.launches += 1
    return SampledNeighbors(ids=ids, mask=mask)


sample_uniform.launches = 0


# ---- weighted sampling ------------------------------------------------------

CHUNK = 256  # the inverse CDF's chunk (the JAX package's sample_biased chunk)
MAX_K = 1024  # K7's and K8's largest k: a warp's list or draws fit shared memory
_NEG_INF = float("-inf")


def _empty(B: int, k: int, dev) -> SampledNeighbors:
    return SampledNeighbors(
        ids=torch.full((B, k), INVALID_ID, dtype=torch.int32, device=dev),
        mask=torch.zeros((B, k), dtype=torch.bool, device=dev),
    )


def gumbel_keys(bits: torch.Tensor, w: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Gumbel (A-Res) keys ``log(u) / w`` of uniform ``u`` from ``bits``, -inf
    where ``live & (w > 0)`` fails.  The log is taken in double and rounded
    once to f32, as K7 and K8 take it, so both compute the same keys."""
    u = prng.bits_to_uniform(bits)
    lg = torch.log(u.double()).float()
    return torch.where(live & (w > 0), lg / w, _NEG_INF)


def _top_k_merge(best_keys, best_off, keys, off, k: int):
    """The ``k`` largest of ``[best; new]`` per row, in ``lax.top_k`` order:
    descending key, the lower offset first on a tie (a stable descending
    sort over entries laid out in offset order)."""
    cat_k = torch.cat([best_keys, keys], dim=1)
    cat_o = torch.cat([best_off, off.expand_as(keys)], dim=1)
    top_k, order = torch.sort(cat_k, dim=1, descending=True, stable=True)
    return top_k[:, :k], torch.gather(cat_o, 1, order[:, :k])


def _seq_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along dim 1, added left to right in f32 (the
    order K7 adds in; ``torch.cumsum`` accumulates in double on the CPU)."""
    out = torch.empty_like(w)
    acc = torch.zeros_like(w[:, 0])
    for c in range(w.shape[1]):
        acc = acc + w[:, c]
        out[:, c] = acc
    return out


def sample_biased_positions(graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key):
    """The plain version of K7's selection, op by op: ``(pos, mask)``, the
    [B, k] positions into ``graph.indices`` that the slots read (clamped
    into the edge list) and which slots are taken; over 256-edge chunks of
    the longest seed row.  Keys: ``row_key [B]`` (replace=False) or
    ``bits [B, k]`` (replace=True).  Needs an edge."""
    B = seeds.shape[0]
    dev = seeds.device
    keys = draw_keys(key, (B, k) if replace else (B,), dev)
    start, deg, valid = _row_extents(graph, seeds)
    n_chunks = -(-int(deg.max()) // CHUNK) if B else 0
    e = torch.arange(CHUNK, dtype=torch.int64, device=dev)
    nnz = graph.num_edges - 1

    def chunk(c):
        off = c * CHUNK + e
        in_row = off[None, :] < deg[:, None]
        pos = torch.clamp(start[:, None] + off[None, :], 0, nnz)
        w = torch.where(in_row, graph.probs[pos], 0.0)
        return off, in_row, pos, w

    if not replace:
        best_k = torch.full((B, k), _NEG_INF, device=dev)
        best_o = torch.zeros((B, k), dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            off, in_row, _, w = chunk(c)
            bits = prng.mix32(keys[:, None] ^ prng.mix32(off)[None, :])
            best_k, best_o = _top_k_merge(best_k, best_o, gumbel_keys(bits, w, in_row), off[None, :], k)
        mask = valid[:, None] & (best_k > _NEG_INF)
        return torch.clamp(start[:, None] + best_o, 0, nnz), mask

    # with replacement: chunk sums in row order, then each draw's chunk
    total = torch.zeros(B, device=dev)
    for c in range(n_chunks):
        total = total + _seq_cumsum(chunk(c)[3])[:, -1]
    target = prng.bits_to_uniform(keys) * total[:, None]  # [B, k]
    before = torch.zeros(B, device=dev)
    picked = torch.zeros((B, k), dtype=torch.int64, device=dev)
    found = torch.zeros((B, k), dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        _, _, pos, w = chunk(c)
        cs = _seq_cumsum(w)
        local = target - before[:, None]
        idx = (cs[:, None, :] <= local[:, :, None]).sum(dim=2)
        here = ~found & (local >= 0) & (local < cs[:, -1:]) & (idx < CHUNK)
        picked = torch.where(here, torch.gather(pos, 1, idx.clamp(max=CHUNK - 1)), picked)
        found |= here
        before = before + cs[:, -1]
    return picked, valid[:, None] & (total[:, None] > 0) & found


def sample_biased_plain(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Plain version of K7 (what :func:`sample_biased` runs for CPU
    tensors), op by op in PyTorch on any device
    (:func:`sample_biased_positions`, then the picks' ids)."""
    if graph.probs is None:
        raise ValueError("sample_biased needs graph.probs")
    B = seeds.shape[0]
    if graph.num_edges == 0 or B * k == 0:
        draw_keys(key, (B, k) if replace else (B,), seeds.device)  # drawn as on the card
        return _empty(B, k, seeds.device)
    pos, mask = sample_biased_positions(graph, seeds, k, replace, key)
    ids = torch.where(mask, graph.indices[pos], INVALID_ID)
    return SampledNeighbors(ids=ids, mask=mask)


def alias_keys(key, B: int, k: int, replace: bool, dev):
    """The keys of one alias-sampler call: ``bits [2, B, k]`` (replace=True)
    or ``(bits [2, B, 4k], gumbel [B, 2k])`` (replace=False), drawn from a
    generator in that order or injected (the JAX package's are
    ``random_keys(key, (2, B, T))`` and ``random_keys(fold_in(key, 1),
    (B, 2k))``).  Returns ``(bits, gumbel or None)``."""
    if replace:
        return draw_keys(key, (2, B, k), dev), None
    if isinstance(key, torch.Generator):
        return draw_keys(key, (2, B, 4 * k), dev), draw_keys(key, (B, 2 * k), dev)
    bits, gum = key
    return draw_keys(bits, (2, B, 4 * k), dev), draw_keys(gum, (B, 2 * k), dev)


def sample_biased_alias_positions(graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key):
    """The plain version of K8's selection, op by op: ``(pos, mask,
    shortfall)``, the [B, k] positions into ``graph.indices`` the slots
    read, which are taken, and the 0-d int32 count of slots the long rows'
    4k draws left unfilled; keys as :func:`alias_keys`.  Needs an edge."""
    B = seeds.shape[0]
    dev = seeds.device
    bits, gum = alias_keys(key, B, k, replace, dev)
    start, deg, valid = _row_extents(graph, seeds)
    nnz = graph.num_edges - 1
    live = valid & (deg > 0)

    def draw(b0, b1):
        j = prng.uniform_mod(b0, deg[:, None]).long()
        pos = torch.clamp(start[:, None] + j, 0, nnz)
        u = prng.bits_to_uniform(b1)
        return torch.where(u < graph.alias_prob[pos], j, graph.alias_idx[pos].long())

    if replace:
        sel = draw(bits[0], bits[1])
        mask = live[:, None].expand(B, k).contiguous()
        return torch.clamp(start[:, None] + sel, 0, nnz), mask, torch.zeros((), dtype=torch.int32, device=dev)

    T, D = 4 * k, 2 * k
    draws = draw(bits[0], bits[1])  # [B, T] offsets in the row
    # short rows: the exact Gumbel top-k over their <= 2k edges
    off = torch.arange(D, dtype=torch.int64, device=dev)
    in_row = off[None, :] < torch.clamp(deg, max=D)[:, None]
    w = torch.where(in_row, graph.probs[torch.clamp(start[:, None] + off, 0, nnz)], 0.0)
    gkey = gumbel_keys(gum, w, in_row)
    top, top_off = torch.sort(gkey, dim=1, descending=True, stable=True)
    top, top_off = top[:, :k], top_off[:, :k]
    # long rows: the first k distinct draws, in draw order
    earlier = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev), diagonal=-1)
    dup = ((draws[:, :, None] == draws[:, None, :]) & earlier).any(dim=2)
    first = ~dup & live[:, None]
    rank = torch.cumsum(first.to(torch.int32), dim=1) - 1
    take = first & (rank < k)
    sel_sparse = torch.zeros((B, k + 1), dtype=torch.int64, device=dev)
    sel_sparse.scatter_(1, torch.where(take, rank, k).long(), draws)  # non-taken draws to column k
    got = take.sum(dim=1)
    jslots = torch.arange(k, device=dev)
    dense = (deg <= D)[:, None]
    sel = torch.where(dense, top_off, sel_sparse[:, :k])
    mask = valid[:, None] & torch.where(dense, top > _NEG_INF, jslots[None, :] < got[:, None])
    long_row = valid & (deg > D)
    shortfall = torch.where(long_row, torch.clamp(k - got, min=0), 0).sum().to(torch.int32)
    return torch.clamp(start[:, None] + sel, 0, nnz), mask, shortfall


def sample_biased_alias_plain(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key
) -> SampledNeighbors:
    """Plain version of K8 (what :func:`sample_biased_alias` runs for CPU
    tensors), op by op in PyTorch on any device
    (:func:`sample_biased_alias_positions`, then the picks' ids).
    ``overflow`` is the 0-d int32 count of slots the long rows' 4k draws
    left unfilled."""
    if graph.alias_prob is None or graph.alias_idx is None or graph.probs is None:
        raise ValueError("sample_biased_alias needs graph.probs and its alias tables")
    B = seeds.shape[0]
    dev = seeds.device
    if graph.num_edges == 0 or B * k == 0:
        alias_keys(key, B, k, replace, dev)  # drawn as on the card
        return _empty(B, k, dev)._replace(overflow=torch.zeros((), dtype=torch.int32, device=dev))
    pos, mask, shortfall = sample_biased_alias_positions(graph, seeds, k, replace, key)
    ids = torch.where(mask, graph.indices[pos], INVALID_ID)
    return SampledNeighbors(ids=ids, mask=mask, overflow=shortfall)


def _check_weighted(graph: Graph, seeds: torch.Tensor, k: int, alias: bool) -> None:
    """Raise ``ValueError`` unless the graph suits K7 (K8 with ``alias``):
    K6's checks, f32 ``probs`` (and f32/int32 alias tables) of [E] on the
    seeds' device, and ``k <= MAX_K``."""
    _check_graph(graph, seeds)
    index = seeds.get_device()
    arrays = [("probs", graph.probs, torch.float32)]
    if alias:
        arrays += [("alias_prob", graph.alias_prob, torch.float32), ("alias_idx", graph.alias_idx, torch.int32)]
    for name, a, dtype in arrays:
        require(
            a is not None and a.get_device() == index and a.dtype == dtype
            and a.is_contiguous() and a.shape == (graph.num_edges,),
            f"{name} must be a contiguous [E] {dtype} tensor on the seeds' CUDA device {index}",
        )
    require(k <= MAX_K, f"the weighted kernels take k <= {MAX_K}, got {k}")


def sample_biased(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Weighted sampling of up to ``k`` in-neighbours per seed row by
    ``graph.probs`` (JAX: ``sample_biased``, ``ops/sampling.py:671-761``):
    K7 on the card, one call per hop (plain version:
    :func:`sample_biased_plain`).  Without replacement the exact Gumbel
    top-k of each row; with replacement the chunked inverse CDF.  Keys are
    drawn (or checked) as the plain version draws them; an edgeless graph or
    an empty output is answered without a launch.  When a row can be longer
    than the kernel's short-row limit (``graph.max_degree``), the call takes
    a workspace sized from ``B``, ``k`` and ``graph.max_degree`` from
    torch's allocator on the seeds' stream; nothing is read back."""
    if seeds.device.type == "cpu":
        return sample_biased_plain(graph, seeds, k, replace, key)
    _check_weighted(graph, seeds, k, alias=False)
    B = seeds.shape[0]
    keys = draw_keys(key, (B, k) if replace else (B,), seeds.device).contiguous()
    if graph.num_edges == 0 or B * k == 0:
        return _empty(B, k, seeds.device)
    ids = torch.empty((B, k), dtype=torch.int32, device=seeds.device)
    mask = torch.empty((B, k), dtype=torch.bool, device=seeds.device)
    lib = _lib()
    stream = stream_of(seeds)
    nbytes = ctypes.c_int64(0)
    check_launch(lib.dg_sample_biased_workspace(B, k, int(graph.max_degree), int(replace), ctypes.byref(nbytes)),
                 "sample_biased workspace")
    work = torch.empty(nbytes.value, dtype=torch.uint8, device=seeds.device) if nbytes.value else None
    rc = lib.dg_sample_biased(
        graph.indptr.data_ptr(), int(graph.indptr.dtype == torch.int64), graph.indices.data_ptr(),
        graph.probs.data_ptr(), seeds.data_ptr(), keys.data_ptr(), ids.data_ptr(), mask.data_ptr(),
        B, k, graph.num_nodes, graph.num_edges, int(replace), int(graph.max_degree),
        None if work is None else work.data_ptr(), nbytes.value, stream,
    )
    check_launch(rc, "sample_biased")
    sample_biased.launches += 1
    return SampledNeighbors(ids=ids, mask=mask)


sample_biased.launches = 0


def sample_biased_alias(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key
) -> SampledNeighbors:
    """Weighted sampling from the Walker alias tables (JAX:
    ``sample_biased_alias``, ``ops/sampling.py:764-895``, without a
    window): K8 on the card, one launch per call (plain version:
    :func:`sample_biased_alias_plain`).  With replacement one alias draw per
    slot; without, the exact Gumbel top-k on rows of degree <= 2k and the
    first k distinct of 4k draws on longer rows.  ``overflow`` is the
    long rows' unfilled slots, a 0-d int32 tensor the kernel adds to on the
    device; nothing is read back."""
    if seeds.device.type == "cpu":
        return sample_biased_alias_plain(graph, seeds, k, replace, key)
    _check_weighted(graph, seeds, k, alias=True)
    B = seeds.shape[0]
    dev = seeds.device
    bits, gum = alias_keys(key, B, k, replace, dev)
    bits = bits.contiguous()
    gum = bits if gum is None else gum.contiguous()  # unread with replacement
    shortfall = torch.zeros((), dtype=torch.int32, device=dev)
    if graph.num_edges == 0 or B * k == 0:
        return _empty(B, k, dev)._replace(overflow=shortfall)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    mask = torch.empty((B, k), dtype=torch.bool, device=dev)
    rc = _lib().dg_sample_biased_alias(
        graph.indptr.data_ptr(), int(graph.indptr.dtype == torch.int64), graph.indices.data_ptr(),
        graph.probs.data_ptr(), graph.alias_prob.data_ptr(), graph.alias_idx.data_ptr(),
        seeds.data_ptr(), bits.data_ptr(), gum.data_ptr(), ids.data_ptr(), mask.data_ptr(),
        shortfall.data_ptr(), B, k, graph.num_nodes, graph.num_edges, int(replace), stream_of(seeds),
    )
    check_launch(rc, "sample_biased_alias")
    sample_biased_alias.launches += 1
    return SampledNeighbors(ids=ids, mask=mask, overflow=shortfall)


sample_biased_alias.launches = 0


def sampler_keys(graph: Graph, B: int, k: int, replace: bool, key, device):
    """The keys one :func:`sample_neighbors` call on ``B`` seeds takes,
    drawn from ``key`` now (or checked, when injected) in the form that
    call accepts, so several calls can draw identically (the owner-side
    sampler's rounds, ``parallel/graph_dist.py``)."""
    if graph.probs is not None and graph.alias_prob is not None:
        bits, gum = alias_keys(key, B, k, replace, device)
        return bits if gum is None else (bits, gum)
    return draw_keys(key, (B, k) if replace else (B,), device)


def sample_neighbors(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key
) -> SampledNeighbors:
    """Dispatch on the graph like the JAX package (``:898-937``), without
    its window branch: a weighted graph with alias tables takes the alias
    sampler (K8), a weighted one without them :func:`sample_biased` (K7),
    any other the uniform sampler (K6).  ``key`` is what the chosen
    sampler takes."""
    if graph.probs is not None:
        if graph.alias_prob is not None:
            return sample_biased_alias(graph, seeds, k, replace, key)
        return sample_biased(graph, seeds, k, replace, key)
    return sample_uniform(graph, seeds, k, replace, key)
