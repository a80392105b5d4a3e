"""Double-buffered training over the host-resident base tier.

Counterpart of ``dist_gnn_tpu/training/pipeline.py``.  Batches are
software-pipelined as there:

    sample(i)               [device; with host structure, hop by hop]
    read back frontier(i)   (waits for sampling)
    queue compute(i-1)      [device, asynchronous]
    stage misses(i)         [host gather + asynchronous copy] ← overlaps compute(i-1)

so a steady step costs ``sample + max(compute, staging)``, not their sum.
Staging runs on the calling thread, as in the JAX package; each batch's
metrics carry its host probe and gather ms and its copy ms on the card,
the numbers that decide whether staging should move to a worker thread.

Two structure modes: the graph whole on the device (``gstore=None``;
``sample_blocks``: K6, K7 or K8 per hop, as the graph decides), or
host-resident structure
(:class:`~dist_gnn_tpu_torch.host_tier.HostCSCStore`): per-hop staging,
with a host round trip between hops, since the next hop's seeds decide
what to stage.

Keys: batch i's sampler and dropout generators are seeded from ``(seed,
i)`` (:func:`batch_keys`, the counterpart of ``fold_in(key, i)``), so a
pipelined run and a sequential one draw the same keys whatever the order
of their calls; hub rows of host structure are presampled from
``np.random.default_rng(seed)`` in batch order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import Graph
from dist_gnn_tpu_torch.host_tier import (
    HostCSCStore,
    HostFeatureStore,
    StagedRows,
    assemble_features,
    copy_ms,
    sample_staged_hop,
)
from dist_gnn_tpu_torch.ops.relabel import unique_and_relabel
from dist_gnn_tpu_torch.sampler import Block, _no_dedup_block, sample_blocks
from dist_gnn_tpu_torch.training.trainer import make_optimizer, masked_nll_loss
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def batch_keys(seed: int, i: int, device: torch.device, rank: int = 0) -> Tuple[torch.Generator, torch.Generator]:
    """Batch ``i``'s (sampler, dropout) generators on ``device``, seeded
    from ``(seed, i)`` alone, or from ``(seed, i, rank)`` for a rank above 0
    of a distributed run (rank 0 draws what a single device draws)."""
    s = np.random.SeedSequence([seed, i, rank] if rank else [seed, i]).generate_state(2, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(v)) for v in s)


@dataclasses.dataclass(eq=False)
class HostTierTrainer:
    """Trainer whose feature base (and optionally structure) is
    host-resident.  The model's parameters and a ``torch.optim.Adam`` it
    owns are updated in place; :meth:`train_batches` drives the pipeline,
    :meth:`sample`, ``store.stage`` and :meth:`compute_step` are its
    phases."""

    model: Any
    fan_out: Tuple[int, ...]
    store: HostFeatureStore
    gstore: Optional[HostCSCStore] = None  # None: the structure is a device Graph
    lr: float = 1e-3
    weight_decay: float = 5e-4
    replace: bool = False
    dedup_last: bool = True
    device: DeviceLike = None  # default: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), self.lr, self.weight_decay)
        if self.replace and self.gstore is not None:
            # the staged-hop samplers (hot tier, staged rows, host hub
            # presampling) draw without replacement only; honouring the flag
            # elsewhere would train another distribution than configured
            raise NotImplementedError(
                "replace=True is not supported with host-resident structure (gstore)"
            )

    # ---- sampling phase --------------------------------------------------

    def _hop(self, seeds, seed_mask, local_rows, staged, k: int, last: bool, key) -> Block:
        nb = sample_staged_hop(self.gstore.hot_graph, local_rows, staged, k, key)
        if last and not self.dedup_last:
            return _no_dedup_block(seeds, seed_mask, nb)
        rl = unique_and_relabel(seeds, nb.ids, nb.mask)
        return Block(
            seeds=seeds,
            seed_mask=seed_mask,
            frontier=rl.frontier,
            frontier_mask=rl.frontier_mask,
            num_frontier=rl.num_frontier,
            neigh_slots=rl.neigh_slots,
            neigh_mask=nb.mask,
        )

    def _sample_host_structure(self, seeds_np, mask_np, key, rng):
        """Per-hop staged sampling.  ``key`` is a generator, or one
        (hot keys, staged keys) pair per hop.  Returns (blocks, host stats,
        the last frontier and its mask as numpy)."""
        blocks = []
        stats = {"struct_miss": 0, "struct_overflow": 0, "struct_remote": 0, "struct_plan_ms": 0.0,
                 "struct_presample_ms": 0.0}
        seeds_h, mask_h = np.asarray(seeds_np), np.asarray(mask_np)
        dev = self.device
        n_hops = len(self.fan_out)
        for i, k in enumerate(reversed(list(self.fan_out))):
            t0 = time.perf_counter()
            local_rows, staged = self.gstore.plan_hop(seeds_h, mask_h, k, rng)
            stats["struct_plan_ms"] += (time.perf_counter() - t0) * 1e3
            stats["struct_presample_ms"] += staged.presample_s * 1e3
            stats["struct_miss"] += staged.count
            stats["struct_overflow"] += staged.overflow
            stats["struct_remote"] += staged.remote
            last = i == n_hops - 1
            hop_key = key if isinstance(key, torch.Generator) else key[i]
            blk = self._hop(
                torch.from_numpy(seeds_h).to(dev), torch.from_numpy(mask_h).to(dev),
                torch.from_numpy(local_rows).to(dev), staged, k, last, hop_key,
            )
            blocks.append(blk)
            seeds_h = blk.frontier.cpu().numpy()
            mask_h = blk.frontier_mask.cpu().numpy()
        return tuple(blocks), stats, seeds_h, mask_h

    def sample(self, graph: Optional[Graph], seeds_np, mask_np, key, rng):
        """Sample one batch: ``(blocks, host stats, frontier_np,
        fmask_np)``.  With a device graph, ``key`` is what
        ``sampler.sample_blocks`` takes and the stats are its overflow
        counters; with host structure see :meth:`_sample_host_structure`."""
        if self.gstore is not None:
            return self._sample_host_structure(seeds_np, mask_np, key, rng)
        dev = self.device
        blocks, sstats = sample_blocks(
            graph, torch.from_numpy(np.asarray(seeds_np)).to(dev),
            torch.from_numpy(np.asarray(mask_np)).to(dev), tuple(self.fan_out),
            self.replace, key, dedup_last=self.dedup_last,
        )
        # the overflow counters reach the metrics: an undersized budget must
        # show, never drop edges silently; the frontier read below waits for
        # sampling anyway
        stats = {k: int(v) for k, v in sstats.items()}
        return blocks, stats, blocks[-1].frontier.cpu().numpy(), blocks[-1].frontier_mask.cpu().numpy()

    # ---- compute phase ---------------------------------------------------

    def compute_step(self, blocks, staged: StagedRows, labels_b, seed_mask, key) -> Dict[str, torch.Tensor]:
        """Assemble the input features (K1 on the hot tier + the staged
        rows), forward in train mode, masked NLL, backward, Adam.  ``key``
        gives the dropout row keys (a generator or injected keys).  Returns
        ``{loss, acc}`` as 0-d device tensors."""
        staged.wait()
        inp = blocks[-1]
        with torch.no_grad():
            feats = assemble_features(
                self.store.hot_tier, inp.frontier, inp.frontier_mask, staged.rows, staged.slots
            )
        loss, acc = masked_nll_loss(self.model, self.dedup_last, blocks, feats, labels_b, seed_mask, key)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), "acc": acc}

    def batch_labels(self, labels_np: np.ndarray, seeds_np, mask_np) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(labels_np)[np.where(mask_np, seeds_np, 0)].astype(np.int32)
        ).to(self.device)

    # ---- the pipeline ----------------------------------------------------

    def train_batches(
        self,
        graph: Optional[Graph],  # device structure (None when gstore is set)
        labels_np: np.ndarray,  # [N] host labels
        batches: Iterable,  # of (seeds_np, mask_np)
        seed: int,
    ) -> List[Dict[str, Any]]:
        """Run all batches double-buffered; returns one metrics dict per
        batch: ``loss`` and ``acc`` (0-d device tensors), ``feat_miss``,
        ``feat_overflow``, ``stage_probe_ms`` and ``stage_gather_ms``
        (host), ``stage_h2d_ms`` (the copy stream's span on the card; None
        on the CPU), plus the sampler's
        ``sampler_overflow``/``frontier_overflow`` or, with host
        structure, ``struct_miss``/``struct_overflow``/``struct_remote``
        (0 on one device) and ``struct_plan_ms`` (host time of the hops'
        planning) with ``struct_presample_ms`` (the part spent presampling
        hub rows).  A batch's
        staged rows are released once its compute is queued; only its copy
        events are kept until the end, for ``stage_h2d_ms``."""
        rng = np.random.default_rng(seed)
        pend = None
        metrics, copies = [], []
        for i, (seeds_np, mask_np) in enumerate(batches):
            seeds_np, mask_np = np.asarray(seeds_np), np.asarray(mask_np)
            sample_key, drop_key = batch_keys(seed, i, self.device)
            blocks, host_stats, frontier_np, fmask_np = self.sample(graph, seeds_np, mask_np, sample_key, rng)
            if pend is not None:
                args, stats_prev = pend
                metrics.append({**self.compute_step(*args), **stats_prev})  # queued
            # host gather + asynchronous copy ride under the queued compute
            staged = self.store.stage(frontier_np, fmask_np)
            copies.append(staged.copy)
            host_stats.update(
                feat_miss=staged.count, feat_overflow=staged.overflow,
                stage_probe_ms=staged.probe_s * 1e3, stage_gather_ms=staged.gather_s * 1e3,
            )
            labels_b = self.batch_labels(labels_np, seeds_np, mask_np)
            mask_t = torch.from_numpy(mask_np).to(self.device)
            pend = ((blocks, staged, labels_b, mask_t, drop_key), host_stats)
        if pend is not None:
            args, stats_prev = pend
            metrics.append({**self.compute_step(*args), **stats_prev})
        for m, copy in zip(metrics, copies):
            m["stage_h2d_ms"] = copy_ms(copy)
        return metrics
