"""Distributed training over a host-resident feature base: the reference's
three-tier data plane (``feature_ops.cu:38-73``: local HBM, peer HBM over
NVLink, pinned host memory).

Counterpart of ``dist_gnn_tpu/parallel/host_dist.py`` on
``torch.distributed``, one process per rank:

  tier 1  local hot rows  — this rank's ``hot_ids`` row on its device,
                            gathered by K1;
  tier 2  peer hot rows   — cached by another rank and fetched from its hot
                            tier through the union routing table
                            (``feature_store.peer_hot_fetch``: owner-routed
                            all-to-all, K1 on the owner);
  tier 3  host base       — the whole matrix in this rank's host memory
                            (an array or ``np.memmap``); each batch's rows
                            hot on no rank are gathered by the native
                            runtime into a pinned slab and copied on a
                            stream of their own while the previous batch
                            computes.

On the two-tier ``('host', 'data')`` mesh the union tables are per host
and the peer-hot round rides the data sub-mesh only: a row hot only on
another host is staged from this host's memory, as the reference keeps
its P2P cache inside a node.

Under a *selfless* plan (disjoint per-rank hot sets, ``cache/policy.py``)
the union covers n times one rank's capacity, so fewer rows are staged
from the host than under the *selfish* plan (every rank the same hot
set); the tests hold the port to that at equal capacity.

:class:`DistHostTrainer` pipelines batches as ``HostTierTrainer`` does:

    sample(i)             [device; with host structure hop by hop]
    read back frontier(i)
    queue compute(i-1)    [assemble 3 tiers, forward, backward, one
                           all-reduce of the gradients, Adam]
    stage misses(i)       [host gather + asynchronous copy] ← under compute(i-1)

Every rank is called with the same global batches and takes its slice.
Each round of the peer-hot fetch reads a pending count back
(``Mesh.sum_to_host``), where the JAX package loops on the device: the
host waits for the exchange at the start of compute(i-1) and only then
reaches stage(i), which still overlaps the forward and backward queued
behind it.  A host of one rank (a world of one, or the mesh ``(H, 1)``)
has nothing peer-hot (the union is its own hot set) and runs no round.

Keys: batch i's sampler and dropout generators are
``pipeline.batch_keys(seed, i, device, rank)`` (rank 0's are a single
device's), or keys a test injects per batch as ``(sample key, dropout row
keys)``: the per-hop keys ``sample_blocks`` takes, or with host structure
one (hot keys, staged keys) pair per hop (``host_tier.sample_staged_hop``).
Hub rows of host structure are presampled from
``np.random.default_rng(seed)`` (``seed ^ 0xE7A1`` in eval), JAX's
``default_rng(uint32(key_data[-1]))`` when ``seed`` is that number.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph
from dist_gnn_tpu_torch.host_tier import HostFeatureStore, HotTier, StagedRows, _hit_rate, copy_ms
from dist_gnn_tpu_torch.parallel.feature_store import _probe, _serve_rows, build_union_tables, peer_hot_fetch, \
    request_budget
from dist_gnn_tpu_torch.parallel.host_struct import check_plan
from dist_gnn_tpu_torch.parallel.mesh import Mesh, check_axis
from dist_gnn_tpu_torch.parallel.trainer_dist import sum_gradients
from dist_gnn_tpu_torch.training.pipeline import HostTierTrainer, batch_keys
from dist_gnn_tpu_torch.training.trainer import dist_masked_nll_loss

# One batch's staged rows on this rank: ``rows`` [count, F] of the frontier
# slots ``slots`` [count], ``count``, ``overflow`` (rows beyond the budget,
# staged all the same) and ``width``, the pinned slab's rows (the budget
# grown in powers of two past the count).
DistStaged = StagedRows


class DistHostFeatureStore(HostFeatureStore):
    """This rank's hot tier on its device, the union routing table of the
    hot ids of every rank of its host (every rank on the flat mesh), and
    the host base (module doc).

    ``hot_ids`` is the [n, C] per-rank feature plan (selfish or selfless,
    ``cache/builder.build_cache_plan``), INVALID padded.  ``miss_budget``
    sizes the common batch's staged slab.  ``axis_name`` is ``'data'`` or,
    on a two-tier mesh, ``('host', 'data')``: then ``num_hosts`` is H and
    ``peer_size`` D, else 1 and n.  ``hot_dtype`` (a torch float dtype)
    casts the hot rows, a raw cast: integer dtypes raise (int8 takes the
    packed store, ``ShardedFeatureStore(quantize=True)``)."""

    def __init__(self, host_features: np.ndarray, mesh: Mesh, hot_ids: np.ndarray, miss_budget: int,
                 axis_name="data", hot_dtype: Optional[torch.dtype] = None):
        self.axis_name, self.hierarchical = check_axis(mesh, axis_name)
        hot_ids = check_plan(hot_ids, mesh)
        super().__init__(host_features, hot_ids[mesh.rank], miss_budget, hot_dtype=hot_dtype, device=mesh.device)
        self.mesh = mesh
        self.num_shards = mesh.size
        self.num_hosts, self.peer_size = mesh.shape if self.hierarchical else (1, mesh.size)
        if self.hot_tier.sorted_ids.numel() == 0:  # one INVALID row, so a peer's request finds a table
            self.hot_tier = HotTier(
                sorted_ids=torch.full((1,), INVALID_ID, dtype=torch.int32, device=self.device),
                rows=torch.zeros((1, self.feature_dim), dtype=self.hot_tier.rows.dtype, device=self.device),
            )
        us, uo = build_union_tables(hot_ids, num_hosts=self.num_hosts)
        if self.num_hosts > 1:  # this rank's host's table (JAX's ``_union_for_chip``)
            host = mesh.rank // self.peer_size
            us, uo = us[host], uo[host]
        self.union_sorted_np = us
        self.union_sorted = torch.from_numpy(np.ascontiguousarray(us)).to(self.device)
        self.union_owner = torch.from_numpy(np.ascontiguousarray(uo)).to(self.device)

    @property
    def peers(self) -> Mesh:
        """The ranks whose hot tiers this rank's peer-hot round reaches:
        its host's (the data sub-mesh) on the two-tier mesh, the world on
        the flat one."""
        return self.mesh.axis("data") if self.hierarchical else self.mesh

    def stage(self, frontier_np: np.ndarray, fmask_np: np.ndarray) -> DistStaged:
        """Host side, for this rank's frontier [L]: gather the masked slots
        hot on no rank of this host (a probe of its union table) from the
        host base into the pinned slab and start their copy.  Lossless:
        every such row is staged, the slab grows past ``miss_budget``."""
        return self._stage(self.union_sorted_np, frontier_np, fmask_np)

    def union_hit_rate(self, ids: np.ndarray) -> float:
        """Share of ``ids`` hot on some rank of this rank's host."""
        return _hit_rate(self.union_sorted_np, ids)

    def assemble_local(
        self,
        ids: torch.Tensor,  # [L] int32 this rank's frontier
        mask: torch.Tensor,  # [L] bool
        staged: DistStaged,
        budget: int,  # per-peer request budget of the peer-hot rounds
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The three tiers' rows for this rank's frontier: ``([L, F] rows,
        peer_dropped)``.  Local hot hits through K1, peer-hot ids from the
        caching rank of this host (lossless rounds over ``peers``, the data
        sub-mesh on the two-tier mesh), staged rows scattered to their
        slots; zero rows where masked out.  ``peer_dropped`` (0-d int32)
        counts ids hot in the union that were neither local nor served: 0
        unless the union table and the serving path disagree.  Every rank
        of ``peers`` calls it in step (it runs collectives when there is
        more than one).  Call ``staged.wait()`` first."""
        hot = self.hot_tier
        pos, local_hit = _probe(hot.sorted_ids, ids, mask)
        out = _serve_rows(hot.rows, pos, local_hit)  # K1
        _, hot_somewhere = _probe(self.union_sorted, ids, mask)
        if self.peers.size > 1:
            peer_rows, peer_served = peer_hot_fetch(
                self.peers, hot.sorted_ids, hot.rows, self.union_sorted, self.union_owner,
                ids, mask & ~local_hit, budget,
            )
            out = torch.where(peer_served[:, None], peer_rows, out)
            local_hit = local_hit | peer_served
        # one rank a host: the union is this rank's own hot set, nothing to fetch
        peer_dropped = (hot_somewhere & ~local_hit).sum(dtype=torch.int32)
        return out.index_copy_(0, staged.slots, staged.rows.to(out.dtype)), peer_dropped


@dataclasses.dataclass(eq=False)
class DistHostTrainer(HostTierTrainer):
    """Distributed trainer over :class:`DistHostFeatureStore` (module doc).
    The structure is a device :class:`Graph` on every rank (``gstore``
    None) or host-resident (``gstore``, a
    :class:`~dist_gnn_tpu_torch.parallel.host_struct.DistHostCSCStore`).
    ``model`` lives on this rank's device (``store.mesh.device``), starts
    from the same parameters on every rank and stays equal to the others;
    the trainer owns its Adam."""

    peer_budget_slack: float = 4.0

    def __post_init__(self):
        self.mesh = self.store.mesh
        self.device = self.mesh.device
        super().__post_init__()

    def _my_slice(self, seeds_np, mask_np):
        """This rank's slice of the global [world_B] batch."""
        seeds_np, mask_np = np.asarray(seeds_np), np.asarray(mask_np)
        n, me = self.mesh.size, self.mesh.rank
        if len(seeds_np) % n:
            raise ValueError(f"a global batch of {len(seeds_np)} does not split over {n} ranks")
        B = len(seeds_np) // n
        return seeds_np[me * B : (me + 1) * B], mask_np[me * B : (me + 1) * B]

    def _features(self, blocks, staged: DistStaged):
        staged.wait()
        inp = blocks[-1]
        budget = request_budget(inp.frontier.shape[0], self.store.peer_size, self.peer_budget_slack)
        return self.store.assemble_local(inp.frontier, inp.frontier_mask, staged, budget)

    def compute_step(self, blocks, staged: DistStaged, labels_b, seed_mask, key) -> Dict[str, torch.Tensor]:
        """Assemble the three tiers, forward in train mode, the masked NLL
        over the global valid count, backward, one all-reduce of the flat
        gradients, Adam.  Returns ``{loss, acc, peer_dropped}`` summed over
        the ranks (one all-reduce), as 0-d device tensors."""
        with torch.no_grad():
            feats, peer_dropped = self._features(blocks, staged)
        loss, (acc_sum, denom) = dist_masked_nll_loss(
            self.model, self.dedup_last, self.mesh, blocks, feats, labels_b, seed_mask, key
        )
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_gradients(self.model, self.mesh)
        self.optimizer.step()
        tot = self.mesh.all_reduce(torch.stack([loss.detach().double(), acc_sum.double(), peer_dropped.double()]))
        return {"loss": tot[0].float(), "acc": (tot[1] / denom).float(), "peer_dropped": tot[2].to(torch.int32)}

    def train_batches(
        self,
        graph: Optional[Graph],  # device structure (None when gstore is set)
        labels_np: np.ndarray,  # [N] host labels
        batches: Iterable,  # of GLOBAL (seeds_np [world_B], mask_np [world_B]), the same on every rank
        seed: int,
        keys=None,  # optional per-batch (sample key, dropout row keys) of this rank
    ) -> List[Dict[str, Any]]:
        """Run every batch double-buffered (stage i under compute i-1), each
        rank on its slice.  Returns one metrics dict per batch: ``loss``,
        ``acc``, ``peer_dropped`` (0-d tensors, over the ranks), and summed
        over the ranks (one all-reduce at the end) ``sample_ms``,
        ``stage_ms``, ``feat_miss``, ``feat_overflow``, the sampler's
        overflow counters or, with host structure, ``struct_miss``,
        ``struct_overflow``, ``struct_remote``, ``struct_plan_ms`` and
        ``struct_presample_ms``; plus this rank's ``stage_h2d_ms`` (its
        copy's span on the card; None on the CPU).  A batch's staged rows
        are freed once its compute is queued."""
        rng = np.random.default_rng(seed)
        pend = None
        metrics, host, copies = [], [], []
        for i, (seeds_np, mask_np) in enumerate(batches):
            seeds_np, mask_np = self._my_slice(seeds_np, mask_np)
            sample_key, drop_key = keys[i] if keys is not None else batch_keys(seed, i, self.device, self.mesh.rank)
            t0 = time.perf_counter()
            blocks, host_stats, frontier_np, fmask_np = self.sample(graph, seeds_np, mask_np, sample_key, rng)
            host_stats["sample_ms"] = (time.perf_counter() - t0) * 1e3
            if pend is not None:
                args, stats_prev = pend
                metrics.append(self.compute_step(*args))  # queued
                host.append(stats_prev)
            # the host gather and the copy ride under the queued compute
            t0 = time.perf_counter()
            staged = self.store.stage(frontier_np, fmask_np)
            labels_b = self.batch_labels(labels_np, seeds_np, mask_np)
            host_stats.update(stage_ms=(time.perf_counter() - t0) * 1e3, feat_miss=staged.count,
                              feat_overflow=staged.overflow)
            copies.append(staged.copy)
            mask_t = torch.from_numpy(mask_np).to(self.device)
            pend = ((blocks, staged, labels_b, mask_t, drop_key), host_stats)
        if pend is not None:
            args, stats_prev = pend
            metrics.append(self.compute_step(*args))
            host.append(stats_prev)
        if not host:
            return metrics
        names = sorted(host[0])
        tot = self.mesh.all_reduce(
            torch.tensor([[h[k] for k in names] for h in host], dtype=torch.float64, device=self.device)
        ).cpu().numpy()
        for m, row, copy in zip(metrics, tot, copies):
            m.update({k: (float(v) if k.endswith("_ms") else int(v)) for k, v in zip(names, row)})
            m["stage_h2d_ms"] = copy_ms(copy)
        return metrics

    @torch.no_grad()  # not inference mode: the pinned ring's buffers are written in place again in training
    def eval_batches(
        self,
        params: Optional[Mapping[str, torch.Tensor]],
        graph: Optional[Graph],
        labels_np: np.ndarray,
        batches: Iterable,  # GLOBAL batches, as train_batches takes
        seed: int,
        keys=None,  # optional per-batch sample keys of this rank
    ) -> Tuple[int, int]:
        """Sampled serving over the host tiers: ``(correct, total)`` over
        every batch and rank.  ``params`` (a state_dict) overrides the
        model's own when given."""
        eseed = seed ^ 0xE7A1
        rng = np.random.default_rng(eseed)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for i, (seeds_np, mask_np) in enumerate(batches):
            seeds_np, mask_np = self._my_slice(seeds_np, mask_np)
            key = keys[i] if keys is not None else batch_keys(eseed, i, self.device, self.mesh.rank)[0]
            blocks, _, frontier_np, fmask_np = self.sample(graph, seeds_np, mask_np, key, rng)
            feats, _ = self._features(blocks, self.store.stage(frontier_np, fmask_np))
            args = (tuple(reversed(blocks)), feats)
            kwargs = {"contiguous_first": not self.dedup_last}
            logits = self.model(*args, **kwargs) if params is None else functional_call(
                self.model, dict(params), args, kwargs)
            lab = self.batch_labels(labels_np, seeds_np, mask_np)
            mask_t = torch.from_numpy(mask_np).to(self.device)
            correct += ((torch.argmax(logits, dim=-1).to(torch.int32) == lab) & mask_t).sum()
            total += mask_t.sum()
        tot = self.mesh.all_reduce(torch.stack([correct, total]))
        return int(tot[0]), int(tot[1])
