"""Mini-batch trainer: training and serving.

Counterpart of ``dist_gnn_tpu/training/trainer.py``.  ``train_step`` runs
one mini-batch: sample all layers, gather the deepest frontier's features
through K1, forward in train mode (SAGE through K3, GAT through K4), the
masked NLL loss, ``backward()`` (K3's and K5's kernels on the card) and an
Adam step.  ``eval_step`` answers a batch of seed-node queries.

The JAX trainer is one jitted function over an explicit ``TrainState``; the
port keeps the params in the model and the moments in a
``torch.optim.Adam`` that the trainer owns, and runs eagerly.  Metrics come
back as 0-d device tensors, so a step does not wait for the device.

Keys: the JAX step derives its sampler and dropout keys from
``fold_in(key, step)``.  Here ``key`` is a ``torch.Generator`` that draws
both in turn, or ``(hop_keys, dropout_keys)``, the per-hop sampler keys
and per-layer dropout row keys a test injects.

The JAX trainer's ``gather_group`` picked a TPU DMA batching for the
Pallas gather and is not carried over: on CUDA the feature gather is
always K1.  Its window knobs (``sampler_window``, ``sampler_big_budget``,
``window_min_slots``) and ``relabel_mode`` choose TPU layouts and are not
carried over either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from dist_gnn_tpu_torch.graph import Graph
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.sampler import sample_blocks
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float) -> torch.optim.Adam:
    """Adam with coupled L2 (gradient += wd * param, then Adam): the JAX
    package's ``optax.chain(add_decayed_weights(wd), adam(lr))``
    (trainer.py:41-47), which is ``torch.optim.Adam``'s own
    ``weight_decay``, not AdamW."""
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


def masked_nll_loss(model, dedup_last: bool, blocks, feats, labels, seed_mask, rng):
    """(loss, acc) over the masked seeds, the training objective
    (trainer.py:59-77): mean NLL of the f32 log-softmax over valid seeds,
    and the share of them predicted right (no gradient)."""
    logits = model(
        tuple(reversed(blocks)), feats, train=True, rng=rng, contiguous_first=not dedup_last
    )
    labels = torch.where(seed_mask, labels, 0)
    ll = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(ll, 1, labels[:, None].long())[:, 0]
    nll = torch.where(seed_mask, nll, 0.0)
    n = torch.clamp(seed_mask.sum(dtype=torch.float32), min=1.0)
    loss = nll.sum() / n
    correct = (torch.argmax(logits, dim=-1).to(torch.int32) == labels) & seed_mask
    acc = correct.sum(dtype=torch.float32) / n
    return loss, acc.detach()


@dataclasses.dataclass(eq=False)
class Trainer:
    model: Any  # nn.Module: forward(blocks, x, train=..., rng=..., contiguous_first=...)
    fan_out: Tuple[int, ...]
    lr: float = 1e-3
    weight_decay: float = 5e-4
    replace: bool = False
    frontier_caps: Any = None  # Optional[Tuple[int, ...]], sampling order
    # False = dedup-free final hop: faster, and the same math for SAGE and GAT
    dedup_last: bool = True
    device: DeviceLike = None  # default: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), self.lr, self.weight_decay)

    def _gather_rows(self, features: torch.Tensor, safe_ids: torch.Tensor) -> torch.Tensor:
        """Feature row gather: K1 on the card."""
        return gather_rows(features, safe_ids)

    def _check_device(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            if t.device.type != self.device.type:
                raise ValueError(
                    f"trainer runs on {self.device}, got a tensor on {t.device}"
                )

    def _sample_and_gather(self, graph, features, seeds, seed_mask, hop_key):
        """Sample every layer and gather the deepest frontier's features.
        Invalid frontier slots gather row 0, a finite real row that every
        consumer masks (the JAX trainer's zero_invalid_rows debug flag is
        not carried over)."""
        blocks, stats = sample_blocks(
            graph, seeds, seed_mask, tuple(self.fan_out), self.replace, hop_key,
            frontier_caps=self.frontier_caps,
            dedup_last=self.dedup_last,
        )
        safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0)
        return blocks, stats, self._gather_rows(features, safe)

    def train_step(
        self,
        graph: Graph,
        features: torch.Tensor,  # [N, F] device store
        labels: torch.Tensor,  # [N] int32
        seeds: torch.Tensor,  # [B] int32, INVALID padded
        seed_mask: torch.Tensor,  # [B] bool
        key,  # torch.Generator, or (per-hop sampler keys, per-layer dropout row keys)
    ) -> Dict[str, torch.Tensor]:
        """One training step: sample, gather (K1), forward in train mode,
        masked NLL, backward, Adam.  Updates the model in place and returns
        ``{loss, acc, sampler_overflow, frontier_overflow}`` as 0-d
        tensors on the device."""
        self._check_device(graph.indices, features, labels, seeds, seed_mask)
        hop_key, drop_key = (key, key) if isinstance(key, torch.Generator) else key
        with torch.no_grad():
            blocks, stats, feats = self._sample_and_gather(graph, features, seeds, seed_mask, hop_key)
            batch_labels = torch.where(seed_mask, labels[torch.where(seed_mask, seeds, 0).long()], 0)
        loss, acc = masked_nll_loss(
            self.model, self.dedup_last, blocks, feats, batch_labels, seed_mask, drop_key
        )
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), "acc": acc, **stats}

    def train_step_multi(
        self,
        graph: Graph,
        features: torch.Tensor,
        labels: torch.Tensor,
        seeds: torch.Tensor,  # [U, B]: U consecutive mini-batches
        seed_masks: torch.Tensor,  # [U, B]
        key,  # torch.Generator, or a sequence of U per-step keys
    ) -> Dict[str, torch.Tensor]:
        """U consecutive :meth:`train_step` calls in a plain loop (the JAX
        trainer fuses them into one program; CUDA-graph capture waits for a
        measurement).  Metrics are the last step's, except the overflow
        counters, which are summed (trainer.py:223-236)."""
        U = seeds.shape[0]
        ovf_keys = ("sampler_overflow", "frontier_overflow")
        totals = {k: torch.zeros((), dtype=torch.int32, device=seeds.device) for k in ovf_keys}
        metrics: Dict[str, torch.Tensor] = {}
        for u in range(U):
            step_key = key if isinstance(key, torch.Generator) else key[u]
            metrics = self.train_step(graph, features, labels, seeds[u], seed_masks[u], step_key)
            for k in ovf_keys:
                totals[k] = totals[k] + metrics[k].to(torch.int32)
        return {**metrics, **totals}

    @torch.inference_mode()
    def eval_step(
        self,
        params: Optional[Mapping[str, torch.Tensor]],
        graph: Graph,
        features: torch.Tensor,  # [N, F] device store
        labels: torch.Tensor,  # [N] int32
        seeds: torch.Tensor,  # [B] int32, INVALID padded
        seed_mask: torch.Tensor,  # [B] bool
        key,  # torch.Generator, or per-hop keys (see sampler.sample_blocks)
    ):
        """Answer one batch of seed-node queries.  Returns ``(correct,
        count)`` as 0-d int tensors: seeds predicted right, valid seeds.
        ``params`` (a state_dict) overrides the model's own when given."""
        self._check_device(graph.indices, features, labels, seeds, seed_mask)
        blocks, _, feats = self._sample_and_gather(graph, features, seeds, seed_mask, key)
        args = (tuple(reversed(blocks)), feats)
        kwargs = {"contiguous_first": not self.dedup_last}
        if params is None:
            logits = self.model(*args, **kwargs)
        else:
            logits = functional_call(self.model, dict(params), args, kwargs)
        safe_seeds = torch.where(seed_mask, seeds, 0).long()
        batch_labels = torch.where(seed_mask, labels[safe_seeds], 0)
        correct = (torch.argmax(logits, dim=-1).to(torch.int32) == batch_labels) & seed_mask
        return correct.sum(dtype=torch.int32), seed_mask.sum(dtype=torch.int32)
