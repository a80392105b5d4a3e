"""Distributed trainer: each rank samples, fetches and trains its slice of
the batch; the gradients are summed over the ranks.

Counterpart of ``dist_gnn_tpu/parallel/trainer_dist.py``.  Per rank and
step: sample every layer (on the replicated graph with ``sample_blocks``,
or owner-side on a :class:`~dist_gnn_tpu_torch.parallel.graph_dist.ShardedGraph`),
fetch the deepest frontier's features from the
:class:`~dist_gnn_tpu_torch.parallel.feature_store.ShardedFeatureStore`
and the seeds' labels from their one-column shards, forward, the masked
NLL over the GLOBAL valid count (``training.dist_masked_nll_loss``),
backward, one all-reduce of every gradient in one flat buffer, and the
same Adam step as :class:`~dist_gnn_tpu_torch.training.Trainer`.  Every
rank starts from the same parameters and so stays equal to the others.
The axis comes from the store: on the two-tier ``('host', 'data')`` mesh
the features ride the store's hierarchical exchange, while the seeds, the
labels, the owner-side sampler and the sums (JAX's ``psum`` over both
axes) run over the flat world, whose index is the rank.
DDP is not used: it averages gradients, where the JAX trainer sums the
gradients of the globally normalised loss.

The JAX step is one jitted ``shard_map``; here each rank runs eagerly and
its collectives are counted on its ``Mesh``.  The lossless exchanges read
a pending count back per round (``feature_store`` module doc).  Like
``Trainer``, the TPU window knobs (``sampler_window``,
``sampler_big_budget``, ``window_min_slots``) and ``relabel_mode`` are not
carried over (ROADMAP Port rule 6).

Keys: the JAX step folds the step and the rank into its key and splits
it into sampler and dropout keys.  Here ``key`` is this rank's
``torch.Generator`` (seeded per rank), or the keys a test injects:
``(hop keys, dropout row keys)``, where a hop's key is what that hop's
sampler takes (``sample_blocks`` on a replicated graph;
``graph_dist.sample_neighbors_cached`` on a sharded one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from dist_gnn_tpu_torch.parallel.feature_store import ShardedFeatureStore, exchange_gather, request_budget
from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph, sample_neighbors_cached
from dist_gnn_tpu_torch.sampler import blocks_from_hops, sample_blocks
from dist_gnn_tpu_torch.training.trainer import dist_masked_nll_loss, make_optimizer

OVERFLOW_KEYS = ("overflow", "sampler_overflow", "frontier_overflow")


def sum_gradients(model, mesh) -> None:
    """One all-reduce (sum) of every gradient of ``model``, packed in a
    flat buffer; a parameter without a gradient contributes zeros."""
    params = list(model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    off = 0
    for p in params:
        p.grad = flat[off : off + p.numel()].view_as(p)
        off += p.numel()


@dataclasses.dataclass(eq=False)
class DistTrainer:
    model: Any  # the nn.Module that Trainer takes, on this rank's device
    fan_out: Tuple[int, ...]
    store: ShardedFeatureStore
    lr: float = 1e-3
    weight_decay: float = 5e-4
    replace: bool = False
    # None: the structure is replicated (a Graph on every rank);
    # a ShardedGraph: owner-side sampling over the exchange
    sgraph: Optional[ShardedGraph] = None
    dedup_last: bool = True  # False = dedup-free final hop (same math for SAGE and GAT)
    frontier_caps: Any = None  # Optional[Tuple[int, ...]], sampling order
    # per-peer budget slack of the sampling exchange: seeds cluster by node
    # range more than frontiers do (rounds repeat past it, losslessly)
    sampler_budget_slack: float = 4.0

    def __post_init__(self):
        self.mesh = self.store.mesh
        self.axis_name = self.store.axis_name  # the store's layout is authoritative
        self.device = self.mesh.device
        self.optimizer = make_optimizer(self.model.parameters(), self.lr, self.weight_decay)

    def _my_slice(self, seeds: torch.Tensor, seed_mask: torch.Tensor):
        """This rank's slice of the global [world_B] batch."""
        n, me = self.mesh.size, self.mesh.rank
        if seeds.shape[0] % n:
            raise ValueError(f"a global batch of {seeds.shape[0]} does not split over {n} ranks")
        B = seeds.shape[0] // n
        return seeds[me * B : (me + 1) * B], seed_mask[me * B : (me + 1) * B]

    def _sample(self, graph, seeds, seed_mask, key):
        if self.sgraph is None:
            return sample_blocks(
                graph, seeds, seed_mask, tuple(self.fan_out), self.replace, key,
                frontier_caps=self.frontier_caps, dedup_last=self.dedup_last,
            )
        gen = isinstance(key, torch.Generator)
        if not gen and len(key) != len(self.fan_out):
            raise ValueError(f"need {len(self.fan_out)} per-hop keys, got {len(key)}")

        def hop(i, s, m, k):
            budget = request_budget(s.shape[0], self.mesh.size, self.sampler_budget_slack)
            return sample_neighbors_cached(self.sgraph, s, m, k, self.replace, key if gen else key[i], budget)

        return blocks_from_hops(hop, seeds, seed_mask, tuple(self.fan_out), self.frontier_caps, self.dedup_last)

    def store_labels_fetch(self, labels_shard: torch.Tensor, seeds: torch.Tensor, seed_mask: torch.Tensor):
        """The seeds' labels from this rank's label shard (``store.shard_of``
        of the [N] or [N, 1] labels), fetched losslessly in one round
        (budget = the seed count: a rank's seeds may all lie in one shard)."""
        return exchange_gather(
            labels_shard.reshape(self.store.shard_size, -1), seeds, seed_mask, self.mesh,
            self.store.shard_size, budget=seeds.shape[0],
        )

    def _inputs(self, graph, labels, seeds, seed_mask, key):
        """Blocks, stats, features and labels of this rank's seeds."""
        blocks, stats = self._sample(graph, seeds, seed_mask, key)
        inp = blocks[-1]
        feats, overflow = self.store.fetch_local(
            inp.frontier, inp.frontier_mask, budget=self.store.request_budget_for(inp.frontier.shape[0])
        )
        lab, _ = self.store_labels_fetch(labels, seeds, seed_mask)
        return blocks, stats, self.store.dequantize(feats), lab[:, 0].to(torch.int32), overflow

    def train_step(
        self,
        graph,  # a Graph on this rank's device, or None with ``sgraph``
        labels: torch.Tensor,  # this rank's label shard, ``store.shard_of(labels)``
        seeds: torch.Tensor,  # [world_B] int32, the global batch
        seed_mask: torch.Tensor,  # [world_B] bool
        key,  # this rank's torch.Generator, or (per-hop keys, dropout row keys)
    ) -> Dict[str, torch.Tensor]:
        """One distributed step on this rank's slice ``rank`` of the global
        batch; every rank calls it with the same batch.  Returns ``{loss,
        acc, overflow, sampler_overflow, frontier_overflow}`` summed over
        the ranks (one all-reduce), as 0-d tensors."""
        seeds, seed_mask = self._my_slice(seeds, seed_mask)
        hop_key, drop_key = (key, key) if isinstance(key, torch.Generator) else key
        with torch.no_grad():
            blocks, stats, feats, lab, overflow = self._inputs(graph, labels, seeds, seed_mask, hop_key)
        loss, (acc_sum, denom) = dist_masked_nll_loss(
            self.model, self.dedup_last, self.mesh, blocks, feats, lab, seed_mask, drop_key
        )
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_gradients(self.model, self.mesh)
        self.optimizer.step()
        tot = self.mesh.all_reduce(torch.stack([
            loss.detach().double(), acc_sum.double(), overflow.double(),
            stats["sampler_overflow"].double(), stats["frontier_overflow"].double(),
        ]))
        return {
            "loss": tot[0].float(), "acc": (tot[1] / denom).float(),
            **{k: tot[2 + i].to(torch.int32) for i, k in enumerate(OVERFLOW_KEYS)},
        }

    def train_step_multi(self, graph, labels, seeds, seed_masks, key) -> Dict[str, torch.Tensor]:
        """``U`` consecutive :meth:`train_step` calls (``seeds``/``seed_masks``
        [U, world_B]) in a plain loop; ``key`` is a generator or U per-step
        keys.  Metrics are the last step's, the overflow counters summed."""
        totals = {k: torch.zeros((), dtype=torch.int32, device=self.device) for k in OVERFLOW_KEYS}
        metrics: Dict[str, torch.Tensor] = {}
        for u in range(seeds.shape[0]):
            step_key = key if isinstance(key, torch.Generator) else key[u]
            metrics = self.train_step(graph, labels, seeds[u], seed_masks[u], step_key)
            for k in OVERFLOW_KEYS:
                totals[k] = totals[k] + metrics[k]
        return {**metrics, **totals}

    @torch.inference_mode()
    def eval_step(
        self,
        params: Optional[Mapping[str, torch.Tensor]],
        graph,
        labels: torch.Tensor,
        seeds: torch.Tensor,  # [world_B] global batch
        seed_mask: torch.Tensor,
        key,  # this rank's torch.Generator, or per-hop keys
    ):
        """Distributed sampled serving: ``(correct, count)`` over the whole
        batch, summed over the ranks, as 0-d int64 tensors.  ``params`` (a
        state_dict) overrides the model's own when given."""
        seeds, seed_mask = self._my_slice(seeds, seed_mask)
        blocks, _, feats, lab, _ = self._inputs(graph, labels, seeds, seed_mask, key)
        args = (tuple(reversed(blocks)), feats)
        kwargs = {"contiguous_first": not self.dedup_last}
        if params is None:
            logits = self.model(*args, **kwargs)
        else:
            logits = functional_call(self.model, dict(params), args, kwargs)
        correct = (torch.argmax(logits, dim=-1).to(torch.int32) == lab) & seed_mask
        tot = self.mesh.all_reduce(torch.stack([correct.sum(), seed_mask.sum()]).to(torch.int64))
        return tot[0], tot[1]
