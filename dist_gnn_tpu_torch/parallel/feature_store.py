"""Sharded feature store with an owner-bucketed all-to-all row exchange.

Counterpart of ``dist_gnn_tpu/parallel/feature_store.py`` on
``torch.distributed``.  Rank ``d`` holds the rows ``[d*S, (d+1)*S)`` of the
feature matrix (S = ``shard_rows``); a fetch

  1. buckets the ids it needs by owner (``owner = id // S``) into a request
     table of ``budget`` slots per owner, where a request's slot is
     ``owner * budget + its rank among the ids for that owner``,
  2. ships the table to the owners (``all_to_all_single``),
  3. lets each owner gather the requested rows from its shard (K1),
  4. ships the rows back and restores request order.

The table layout is the JAX package's, slot for slot (the owner-side
sampler draws its keys by table position, so samples stay equal to JAX's
only on the same layout); the ranks within an owner come from one stable
sort by owner instead of JAX's masked cumsums.

**Lossless** (the default): requests beyond the budget ride further
rounds until every one is served.  Each round ends in one all-reduce of
the pending count, read back to the host: the loop's only host sync, one
per round.  ``lossless=False`` drops what overflows and counts it.  Ids
outside the table come back as zero rows and are counted, never served
clipped.  A world of one skips the exchange: its shard is the table.

Optional tiers: a per-rank **hot tier** (rows cached on this rank, served
without the exchange), a **peer-hot** tier (rows cached on another rank,
fetched from that rank's hot tier through a replicated id → owner table),
and **int8 packing** (``ops/quantize.py``), whose rows ride every gather
and exchange as ``F + 4`` bytes and are dequantized by the consumer.

**Hierarchical** (``exchange_gather_hier``, on the two-tier ``('host',
'data')`` mesh of ``mesh.make_mesh(hosts=H)``): each round buckets the
requests by owner *host* and ships them over the host sub-mesh, where
they land on the chip of the same intra-host index; that chip re-buckets
them by owner chip and ships them over the data sub-mesh; the owner
serves through K1 with a served-flag column appended, and the responses
retrace both stages.  Requests cross the slow tier once each, and the
peer-hot tier of a hierarchical store stays inside a host (per-host union
tables, rounds on the data sub-mesh), as the reference keeps its P2P
cache inside a node.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import INVALID_ID
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.ops.hashtable import SortedIdTable
from dist_gnn_tpu_torch.ops.quantize import dequantize_unpack, quantize_pack
from dist_gnn_tpu_torch.parallel.mesh import Mesh, check_axis

_PAD_KEY = np.iinfo(np.int32).max  # sorts after every id; equals INVALID_ID


def shard_rows(num_rows: int, num_shards: int) -> int:
    """Rows per shard (ceil): ``owner = id // shard_rows``."""
    return -(-num_rows // num_shards)


def request_budget(num_ids: int, num_shards: int, slack: float = 2.0) -> int:
    """Per-peer request budget: the even share of ``num_ids`` times
    ``slack``, at most ``num_ids`` (which makes one round lossless)."""
    return min(num_ids, max(1, int(-(-num_ids // num_shards) * slack)))


class ExchangePlan(NamedTuple):
    """What maps a response back to request order."""

    slot: torch.Tensor  # [L] int32 slot in the flat [n*budget] table (n*budget if not sent)
    in_budget: torch.Tensor  # [L] bool — sent this round


def make_request(
    ids: torch.Tensor,  # [L] int32 global ids (INVALID padded)
    mask: torch.Tensor,  # [L] bool
    mesh: Mesh,
    shard_size: int,
    budget: int,
    owners: Optional[torch.Tensor] = None,  # [L] explicit owner per id
) -> Tuple[ExchangePlan, torch.Tensor, torch.Tensor]:
    """Bucket ``ids`` by owner and all-to-all the request table.  Returns
    ``(plan, recv [n, budget]`` — the ids the peers want from this rank,
    ``INVALID_ID`` in unused slots — ``, overflow)``, the 0-d int32 count
    of masked ids beyond their owner's budget.  ``owners`` overrides the
    node-range routing (the peer-hot tier routes by the union table)."""
    n = mesh.size
    L = ids.shape[0]
    dev = ids.device
    if owners is None:
        owner = torch.where(mask, torch.clamp(torch.div(ids, shard_size, rounding_mode="floor"), 0, n - 1), n)
    else:
        owner = torch.where(mask & (owners >= 0) & (owners < n), owners, n)
    owner = owner.to(torch.int64)
    # rank of each id among the ids of its owner, in request order
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n + 1)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty(L, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(L, device=dev) - first[owner[order]]
    valid = mask & (owner < n)
    in_budget = valid & (rank < budget)
    slot = torch.where(in_budget, owner * budget + rank, n * budget)
    req = torch.full((n * budget + 1,), INVALID_ID, dtype=torch.int32, device=dev)
    req[slot] = torch.where(valid, ids, INVALID_ID).to(torch.int32)  # the extra slot takes the rest
    overflow = (valid & ~in_budget).sum(dtype=torch.int32)
    recv = mesh.all_to_all(req[: n * budget].reshape(n, budget))
    plan = ExchangePlan(slot=slot.to(torch.int32), in_budget=in_budget)
    return plan, recv, overflow


def return_response(plan: ExchangePlan, served: torch.Tensor, mesh: Mesh, fill=0) -> torch.Tensor:
    """All-to-all the owners' payload ``served [n, budget, ...]`` back and
    restore request order (a K1 gather of the flat response): ``[L, ...]``,
    ``fill`` where a request was not sent."""
    resp = mesh.all_to_all(served)
    n, budget = resp.shape[0], resp.shape[1]
    tail = resp.shape[2:]
    flat = resp.reshape(n * budget, -1)
    got = gather_rows(flat, torch.clamp(plan.slot, 0, n * budget - 1)).reshape((-1,) + tuple(tail))
    keep = plan.in_budget.reshape((-1,) + (1,) * len(tail))
    return torch.where(keep, got, torch.as_tensor(fill, dtype=got.dtype, device=got.device))


def _serve_rows(local_shard: torch.Tensor, local_idx: torch.Tensor, serve: torch.Tensor) -> torch.Tensor:
    """Rows ``local_shard[local_idx]`` through K1, zero where not ``serve``."""
    safe = torch.where(serve, local_idx, 0).to(torch.int32).reshape(-1)
    rows = gather_rows(local_shard, safe).reshape(serve.shape + (local_shard.shape[1],))
    return torch.where(serve[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def exchange_gather(
    local_shard: torch.Tensor,  # [shard_size, F] — this rank's row range
    ids: torch.Tensor,  # [L] int32 global ids (INVALID padded)
    mask: torch.Tensor,  # [L] bool
    mesh: Mesh,
    shard_size: int,
    budget: Optional[int] = None,
    lossless: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([L, F] rows, unserved)``: each masked id's row from its owner's
    shard, zeros for masked-out ids.  ``unserved`` (0-d int32) counts the
    masked ids outside the table (zero rows) plus, when not ``lossless``,
    the requests the budget dropped; lossless rounds serve every other id.
    ``budget`` defaults to :func:`request_budget`.  A world of one gathers
    straight from its shard (K1), without a collective."""
    n = mesh.size
    in_range = mask & (ids >= 0) & (ids < n * shard_size)
    oor = (mask & ~in_range).sum(dtype=torch.int32)
    if n == 1:
        return _serve_rows(local_shard, ids, in_range), oor
    Pb = budget if budget is not None else request_budget(ids.shape[0], n)
    base = mesh.rank * shard_size
    pending = in_range
    out = torch.zeros((ids.shape[0], local_shard.shape[1]), dtype=local_shard.dtype, device=ids.device)
    while True:
        plan, recv, ovf = make_request(ids, pending, mesh, shard_size, Pb)
        local_idx = recv.to(torch.int64) - base
        serve = (recv != INVALID_ID) & (local_idx >= 0) & (local_idx < local_shard.shape[0])
        got = return_response(plan, _serve_rows(local_shard, local_idx, serve), mesh)
        served = pending & plan.in_budget
        out = torch.where(served[:, None], got, out)
        pending = pending & ~served
        if not lossless:
            return out, ovf + oor
        if mesh.sum_to_host(pending.sum()) == 0:
            return out, pending.sum(dtype=torch.int32) + oor


def exchange_gather_hier(
    local_shard: torch.Tensor,  # [shard_size, F] — this rank's row range
    ids: torch.Tensor,  # [L] int32 global ids (INVALID padded)
    mask: torch.Tensor,  # [L] bool
    mesh: Mesh,  # the two-tier mesh (its host and data sub-meshes)
    shard_size: int,
    budget_host: Optional[int] = None,
    budget_data: Optional[int] = None,
    lossless: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage exchange of a two-tier mesh (module doc):
    ``([L, F] rows, unserved)`` as :func:`exchange_gather` returns them.
    Stage 1 rides the host sub-mesh with ``budget_host`` slots per owner
    host (default :func:`request_budget` over H), stage 2 the data
    sub-mesh with ``budget_data`` per owner chip (default ``H *
    budget_host``, which stage 1 cannot overflow).  A request can miss
    either stage, so every served row carries a flag column back; lossless
    rounds repeat both stages until no rank has one pending, one world
    all-reduce of the pending count a round, read back.  ``lossless=False``
    does one round and counts both stages' overflow.  A world of one
    gathers straight from its shard when lossless."""
    H, D = mesh.shape
    n = mesh.size
    host, data = mesh.axis("host"), mesh.axis("data")
    L, F = ids.shape[0], local_shard.shape[1]
    Bh = budget_host if budget_host is not None else request_budget(L, H)
    Bd = budget_data if budget_data is not None else H * Bh
    # ids outside the table are unservable: zero rows, counted, never pending
    in_range = mask & (ids >= 0) & (ids < n * shard_size)
    oor = (mask & ~in_range).sum(dtype=torch.int32)
    if n == 1 and lossless:
        return _serve_rows(local_shard, ids, in_range), oor
    base = mesh.rank * shard_size
    pending = in_range
    out = torch.zeros((L, F), dtype=local_shard.dtype, device=ids.device)
    while True:
        owner = torch.where(pending, torch.clamp(torch.div(ids, shard_size, rounding_mode="floor"), 0, n - 1), n)
        plan1, recv1, ovf1 = make_request(ids, pending, host, shard_size, Bh,
                                          owners=torch.div(owner, D, rounding_mode="floor"))
        relay = recv1.reshape(-1)  # [H * Bh] requests now on their owner host
        rmask = relay != INVALID_ID
        owner_chip = torch.where(rmask, torch.remainder(torch.div(relay, shard_size, rounding_mode="floor"), D), D)
        plan2, recv2, ovf2 = make_request(relay, rmask, data, shard_size, Bd, owners=owner_chip)
        local_idx = recv2.to(torch.int64) - base
        serve = (recv2 != INVALID_ID) & (local_idx >= 0) & (local_idx < local_shard.shape[0])
        rows = _serve_rows(local_shard, local_idx, serve)  # [D, Bd, F]
        # the flag tells a stage-2 drop from a zero row
        payload = torch.cat([rows, serve[..., None].to(rows.dtype)], dim=-1)
        back1 = return_response(plan2, payload, data)  # [H * Bh, F + 1]
        got = return_response(plan1, back1.reshape(H, Bh, F + 1), host)  # [L, F + 1]
        served = pending & plan1.in_budget & (got[:, F] > 0)
        out = torch.where(served[:, None], got[:, :F], out)
        pending = pending & ~served
        if not lossless:
            return out, ovf1 + ovf2 + oor
        if mesh.sum_to_host(pending.sum()) == 0:
            return out, pending.sum(dtype=torch.int32) + oor


def build_union_tables(hot_ids: np.ndarray, num_hosts: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """The peer-hot tier's id → owner tables over the hot ids (``hot_ids``
    [n, C], INVALID padded; an id cached by several owners routes to the
    lowest).  ``num_hosts == 1``: one table ``(sorted ids [U], owner [U])``
    over every rank, owner the rank (the flat mesh).  ``num_hosts == H``:
    per-host tables ``[H, U]`` over the ``D = n // H`` ranks of each host,
    owner the intra-host index (the two-tier mesh: rows hot only on
    another host are not in a host's table).  Padding holds int32.max,
    which matches no real id."""
    n, C = hot_ids.shape
    if n % num_hosts:
        raise ValueError(f"{n} ranks do not split into {num_hosts} hosts")
    D = n // num_hosts
    tables = []
    for h in range(num_hosts):
        flat = hot_ids[h * D : (h + 1) * D].reshape(-1)
        owners = np.repeat(np.arange(D, dtype=np.int32), C)
        keep = flat != INVALID_ID
        tbl = SortedIdTable.build(flat[keep], priority=owners[keep], owners=owners[keep], device="cpu")
        tables.append((tbl.sorted_ids.numpy(), tbl.owners.numpy()))
    U = max(max(len(s) for s, _ in tables), 1)
    us = np.full((num_hosts, U), _PAD_KEY, np.int32)
    uo = np.zeros((num_hosts, U), np.int32)
    for h, (s, o) in enumerate(tables):
        us[h, : len(s)] = s
        uo[h, : len(o)] = o
    return (us[0], uo[0]) if num_hosts == 1 else (us, uo)


def _probe(sorted_ids: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos, hit)`` of ``ids`` in a sorted id table: ``pos`` clipped into
    the table, ``hit`` where the masked id is there."""
    C = sorted_ids.shape[0]
    pos = torch.clamp(torch.searchsorted(sorted_ids, ids), 0, max(C - 1, 0))
    return pos, mask & (C > 0) & (sorted_ids[pos] == ids)


def peer_hot_fetch(
    mesh: Mesh,
    hot_sorted: torch.Tensor,  # [C] this rank's sorted hot ids
    hot_rows: torch.Tensor,  # [C, F] their rows
    union_sorted: torch.Tensor,  # [U] every rank's hot ids, sorted
    union_owner: torch.Tensor,  # [U] the rank that serves each
    ids: torch.Tensor,
    mask: torch.Tensor,
    budget: int,
    lossless: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve ids from the hot tier of the rank that caches them:
    ``([L, F] rows, served [L])``.  Requests route by the union table; each
    rank probes its own hot tier and serves hits through K1.  Lossless by
    default (overflow rides further rounds); with ``lossless=False`` the
    overflow is left unserved (``served`` False) for the base tier."""
    n = mesh.size
    upos, hot_somewhere = _probe(union_sorted, ids, mask)
    owner = torch.where(hot_somewhere, union_owner[upos], n)
    pending = hot_somewhere
    out = torch.zeros((ids.shape[0], hot_rows.shape[1]), dtype=hot_rows.dtype, device=ids.device)
    while True:
        plan, recv, _ = make_request(ids, pending, mesh, 1, budget, owners=owner)
        rflat = recv.reshape(-1)
        spos, serve = _probe(hot_sorted, rflat, rflat != INVALID_ID)
        rows = _serve_rows(hot_rows, spos, serve).reshape(n, budget, -1)
        got = return_response(plan, rows, mesh)
        served = pending & plan.in_budget
        out = torch.where(served[:, None], got, out)
        pending = pending & ~served
        if not lossless or mesh.sum_to_host(pending.sum()) == 0:
            return out, hot_somewhere & ~pending


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


class ShardedFeatureStore:
    """A feature matrix row-sharded over the ranks, fetched through
    :func:`exchange_gather` (or :func:`exchange_gather_hier` when
    ``hierarchical``), with the optional hot, peer-hot and int8 tiers
    (module doc).  Every rank builds it from the same host matrix and keeps
    only its padded row range and its own hot rows on its device.

    ``axis_name`` is ``'data'`` on the flat mesh or ``('host', 'data')`` on
    the two-tier one; either way rank ``r`` holds shard ``r``.
    ``hierarchical`` (the tuple axis only) takes the two-stage exchange and
    keeps the peer-hot tier inside a host.  ``hot_ids`` is the [n, C]
    INVALID-padded matrix of per-rank hot ids of
    ``cache/builder.build_cache_plan``.  ``quantize`` packs the rows to
    int8 (``features`` must then be float; :meth:`dequantize` unpacks a
    fetch).  ``features`` is a numpy array or a tensor of any dtype."""

    def __init__(
        self,
        features: Union[np.ndarray, torch.Tensor],
        mesh: Mesh,
        axis_name="data",
        budget_slack: float = 2.0,
        hot_ids: Optional[np.ndarray] = None,
        quantize: bool = False,
        hierarchical: bool = False,
        peer_hot: bool = False,
        lossless: bool = True,
    ):
        self.axis_name, two_tier = check_axis(mesh, axis_name)
        if hierarchical and not two_tier:
            raise ValueError("the hierarchical exchange needs the ('host', 'data') axis pair")
        self.mesh = mesh
        self.hierarchical = hierarchical
        self.quantized = quantize
        self.lossless = lossless
        self.peer_hot = peer_hot
        self.budget_slack = budget_slack
        self.out_dim = features.shape[1]
        if quantize:
            f = features.float().cpu().numpy() if isinstance(features, torch.Tensor) else features
            features = quantize_pack(f)
        features = _as_tensor(features)
        n, me = mesh.size, mesh.rank
        self.num_rows = features.shape[0]
        self.num_shards = n
        self.shard_size = shard_rows(self.num_rows, n)
        self.features = self.shard_of(features)
        self.hot_sorted = self.hot_rows = self.union_sorted = self.union_owner = None
        if hot_ids is not None:
            hot_ids = np.asarray(hot_ids, np.int32)
            if hot_ids.shape[0] != n:
                raise ValueError(f"hot_ids has {hot_ids.shape[0]} rows for {n} ranks")
            mine = np.sort(hot_ids[me]).astype(np.int32)  # INVALID_ID (int32.max) sorts last
            safe = torch.from_numpy(np.clip(mine, 0, self.num_rows - 1).astype(np.int64))
            rows = features[safe.to(features.device)].to(mesh.device)
            rows[torch.from_numpy(mine == INVALID_ID).to(mesh.device)] = 0
            self.hot_sorted = torch.from_numpy(mine).to(mesh.device)
            self.hot_rows = rows.contiguous()
            if peer_hot:
                if hierarchical:  # this host's table: owners are intra-host indices
                    H, D = mesh.shape
                    us, uo = build_union_tables(hot_ids, num_hosts=H)
                    if H > 1:
                        us, uo = us[me // D], uo[me // D]
                else:
                    us, uo = build_union_tables(hot_ids)
                self.union_sorted = torch.from_numpy(np.ascontiguousarray(us)).to(mesh.device)
                self.union_owner = torch.from_numpy(np.ascontiguousarray(uo)).to(mesh.device)

    @property
    def feature_dim(self) -> int:
        return self.out_dim

    def shard_of(self, values: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """This rank's padded row range ``[rank*S, (rank+1)*S)`` of a
        [N, ...] host array, on its device: how a label column (or any
        per-node array) is sharded like the features."""
        values = _as_tensor(values)
        S, lo = self.shard_size, self.mesh.rank * self.shard_size
        part = values[lo : min(lo + S, values.shape[0])].to(self.mesh.device)
        if part.shape[0] < S:
            pad = torch.zeros((S - part.shape[0],) + tuple(values.shape[1:]), dtype=values.dtype,
                              device=self.mesh.device)
            part = torch.cat([part, pad])
        return part.contiguous()

    def request_budget_for(self, num_ids: int) -> int:
        """The first-stage budget of a fetch of ``num_ids`` ids: per rank
        for the flat exchange, per host for the hierarchical one."""
        n = self.mesh.shape[0] if self.hierarchical else self.num_shards
        return request_budget(num_ids, n, self.budget_slack)

    def dequantize(self, rows: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Undo the int8 packing after a fetch (the rows unchanged when the
        store is not quantized)."""
        return dequantize_unpack(rows, out_dtype) if self.quantized else rows

    def _exchange(self, ids, mask, budget):
        if self.hierarchical:
            return exchange_gather_hier(
                self.features, ids, mask, self.mesh, self.shard_size, budget_host=budget, lossless=self.lossless
            )
        return exchange_gather(
            self.features, ids, mask, self.mesh, self.shard_size, budget=budget, lossless=self.lossless
        )

    def fetch_local(self, ids: torch.Tensor, mask: torch.Tensor, budget: Optional[int] = None):
        """This rank's rows for ``ids``: ``([L, F] rows, unserved)``.  Hot
        hits come from this rank's hot tier (K1), peer-hot ids from the
        caching rank's, the rest through the exchange.  Every rank calls
        it in step (it runs collectives)."""
        if self.hot_sorted is None:
            return self._exchange(ids, mask, budget)
        pos, hit = _probe(self.hot_sorted, ids, mask)
        hot_out = _serve_rows(self.hot_rows, pos, hit)
        miss = mask & ~hit
        peer_out = peer_served = None
        if self.union_sorted is not None:
            if self.hierarchical:  # inside the host; ``budget`` is the host stage's
                peers = self.mesh.axis("data")
                Pb = request_budget(ids.shape[0], peers.size, self.budget_slack)
            else:
                peers = self.mesh
                Pb = budget if budget is not None else request_budget(ids.shape[0], self.num_shards)
            peer_out, peer_served = peer_hot_fetch(
                peers, self.hot_sorted, self.hot_rows, self.union_sorted, self.union_owner,
                ids, miss, Pb,
            )
            miss = miss & ~peer_served
        cold_out, unserved = self._exchange(ids, miss, budget)
        if peer_out is not None:
            cold_out = torch.where(peer_served[:, None], peer_out, cold_out)
        return torch.where(hit[:, None], hot_out, cold_out), unserved

    def hot_hit_rate(self, ids: np.ndarray) -> float:
        """Diagnostic: the share of ``ids`` this rank's hot tier holds."""
        if self.hot_sorted is None:
            return 0.0
        hs = self.hot_sorted.cpu().numpy()
        pos = np.clip(np.searchsorted(hs, ids), 0, len(hs) - 1)
        return float(np.mean(hs[pos] == ids))

    def fetch(self, ids: torch.Tensor, mask: torch.Tensor):
        """A standalone fetch of this rank's ``ids`` from the base shards:
        ``(rows, unserved summed over the ranks)``.  Every rank calls it."""
        rows, unserved = self._exchange(ids, mask, self.request_budget_for(ids.shape[0]))
        return rows, self.mesh.all_reduce(unserved.clone())
