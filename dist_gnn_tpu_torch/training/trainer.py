"""Mini-batch trainer: the serving half.

Counterpart of ``dist_gnn_tpu/training/trainer.py``.  This slice ports
``Trainer._gather_rows`` and ``Trainer.eval_step``: sampled mini-batch
inference, which answers a batch of seed-node queries (sample all layers,
gather the deepest frontier's features through K1, SAGE forward through
K3, count correct predictions).  ``train_step``, ``train_step_multi``,
``masked_nll_loss`` and the optimizer (Adam with coupled L2) come in the
training slice.

The JAX trainer's ``gather_group`` picked a TPU DMA batching for the
Pallas gather and is not carried over: on CUDA the feature gather is
always K1.  Its window knobs (``sampler_window``, ``sampler_big_budget``,
``window_min_slots``) and ``relabel_mode`` choose TPU layouts and are not
carried over either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from dist_gnn_tpu_torch.graph import Graph
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.sampler import sample_blocks
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(eq=False)
class Trainer:
    model: Any  # nn.Module: forward(blocks, x, contiguous_first=...)
    fan_out: Tuple[int, ...]
    replace: bool = False
    frontier_caps: Any = None  # Optional[Tuple[int, ...]], sampling order
    # False = dedup-free final hop: faster, and the same math for SAGE
    dedup_last: bool = True
    device: DeviceLike = None  # default: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _gather_rows(self, features: torch.Tensor, safe_ids: torch.Tensor) -> torch.Tensor:
        """Feature row gather: K1 on the card."""
        return gather_rows(features, safe_ids)

    def _check_device(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            if t.device.type != self.device.type:
                raise ValueError(
                    f"trainer runs on {self.device}, got a tensor on {t.device}"
                )

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
        blocks, _ = sample_blocks(
            graph, seeds, seed_mask, tuple(self.fan_out), self.replace, key,
            frontier_caps=self.frontier_caps,
            dedup_last=self.dedup_last,
        )
        # invalid frontier slots gather row 0, a finite real row that every
        # consumer masks (the JAX trainer's zero_invalid_rows debug flag
        # is not carried over)
        safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0)
        feats = self._gather_rows(features, safe)
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
