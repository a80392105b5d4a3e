"""What the drivers share: weights and traffic made from the seed, the
percentile of step times, and the numbers that decide ``correct``."""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from gnnbench.graphgen import generator
from gnnbench.reference import models as ref_models

# streams of the run's seed (graphgen uses 0)
SEED_ORDER, KEYS, WEIGHTS, SAMPLE_ROWS = 1, 2, 3, 4


def make_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's float32 parameters in the program's layout, made on
    ``device`` in two calls: Glorot-uniform matrices, ``0.1 * N(0, 1)``
    attention vectors (GAT), zero biases."""
    shapes = ref_models.family(cfg["model"]["family"]).param_shapes(cfg)
    g = generator(seed, device, WEIGHTS)
    glorot = {k: s for k, s in shapes.items() if k.split(".")[1] in ("w_self", "w_neigh", "w")}
    normal = {k: s for k, s in shapes.items() if k.split(".")[1] in ("a_l", "a_r")}
    u = torch.rand(sum(a * b for a, b in glorot.values()), generator=g, device=device)
    z = torch.randn(max(1, sum(a * b for a, b in normal.values())), generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        if k in glorot:
            limit = (6.0 / (s[0] + s[1])) ** 0.5
            out[k] = ((2 * u[iu : iu + n] - 1) * limit).reshape(s)
            iu += n
        elif k in normal:
            out[k] = (0.1 * z[iz : iz + n]).reshape(s)
            iz += n
        else:
            out[k] = torch.zeros(s, device=device)
    return out


class Feed:
    """Mini-batches of training seeds, an epoch shuffle of them at a time
    drawn from the seed, and every step's row keys: per hop of the sampler
    and per dropout layer, drawn in one call."""

    def __init__(self, train_idx: torch.Tensor, batch: int, seed: int, device: torch.device,
                 hop_sizes: Sequence[int], drop_sizes: Sequence[int]):
        from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator

        self.seeds = SeedGenerator(train_idx.cpu().numpy(), batch, shuffle=True, drop_last=True, device=device)
        self.order = generator(seed, device, SEED_ORDER)
        self.keys = generator(seed, device, KEYS)
        self.device = device
        self.sizes = list(hop_sizes) + list(drop_sizes)
        self.n_hops = len(hop_sizes)
        self._epoch: Iterator = iter(())

    def next(self):
        """``(seeds, seed_mask, (hop_keys, drop_keys))``."""
        try:
            seeds, mask = next(self._epoch)
        except StopIteration:
            self._epoch = self.seeds.epoch(self.order)
            seeds, mask = next(self._epoch)
        bits = torch.randint(0, 2**32, (sum(self.sizes),), generator=self.keys, device=self.device,
                             dtype=torch.int64)
        parts = list(torch.split(bits, self.sizes))
        return seeds, mask, (parts[: self.n_hops], parts[self.n_hops :])


def p95(values: Sequence[float]) -> float:
    """The 95th percentile (inclusive quantiles) of ``values``."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


def note(what: str, since: float) -> None:
    """A line on standard error: ``what`` and the seconds since ``since``."""
    print(f"gnnbench: {what} at {time.perf_counter() - since:.3f} s", file=sys.stderr, flush=True)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---- the numbers that decide correct ------------------------------------------


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             counted: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's:
    ``(gap, leaf)``."""
    norms = {k: float(ref[k].double().norm()) for k in counted}
    med = statistics.median(norms.values())
    worst, which = 0.0, ""
    for k in counted:
        gap = abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
        if gap > worst:
            worst, which = gap, k
    return worst, which


def moved_leaves(ref_grad: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least ``share`` of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= share * med]


def logit_gap(got: torch.Tensor, want: torch.Tensor, mask: torch.Tensor) -> float:
    """The widest gap of a valid seed's logit from the reference's, over the
    reference's largest logit magnitude."""
    g, w = got.float()[mask], want.float()[mask]
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30) if w.numel() else 0.0


# the numbers a program's run brings from its comparison with the reference
COUNTED = ("blocks_differing", "rows_differing", "logit_gap")


def train_checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers: the sampled blocks and gathered rows that differ
    (counts), the worst step's logit gap and loss gap, the first gradient's
    and the three steps' change's worst-leaf gaps.  ``prog`` and ``ref``
    hold ``loss`` [steps], ``g1``, ``delta`` (leaf dicts); ``prog`` also the
    numbers of ``COUNTED``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    leaves = list(ref["g1"])
    grad_gap, _ = leaf_gap(prog["g1"], ref["g1"], leaves)
    moved = moved_leaves(ref["g1"])
    update_gap, _ = leaf_gap(prog["delta"], ref["delta"], moved)
    return {
        "blocks_differing": float(prog["blocks_differing"]),
        "rows_differing": float(prog["rows_differing"]),
        "logit_gap": float(prog["logit_gap"]),
        "loss_gap": loss_gap,
        "grad_gap": grad_gap,
        "update_gap": update_gap,
    }
