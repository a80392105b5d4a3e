"""What every model family of the plain reference shares: float32 products
with TF32 off, the rounding ``q`` to the precision under test, dropout
from the program's keys, the masked NLL, Adam with coupled weight decay,
and the lookup of a family's own module by name
(``gnnbench/reference/<family>.py``: its forward over sampled blocks, its
full pass, its parameters' layout and its model operations).

Dropout keeps an element where ``prng.keep_mask`` says so and scales it by
``1 / (1 - rate)``.  ``q`` rounds a tensor to the precision under test
(identity for the float32 reference); a family applies it where the
configured compute dtype rounds: the layer inputs, the weights and the
layer outputs.  Parameters are a dict ``{"layer{l}.<name>": tensor}`` in
the program's layout.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, Iterator, List, Sequence

import torch

from gnnbench.reference import prng

Quant = Callable[[torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """float32 products in float32, not TF32, for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 rounding in the forward pass, the gradient passed
    straight through."""
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


def dropout(h, row_keys, rate: float):
    keep = prng.keep_mask(row_keys, h.shape[1], 1.0 - rate)
    return torch.where(keep, h / (1.0 - rate), 0.0)


def slot_mean(h, slots, mask):
    m = mask.to(h.dtype)
    nb = h[slots.long()] * m[..., None]
    return nb.sum(1) / torch.clamp(m.sum(1), min=1.0)[:, None]


def masked_nll(logits, labels, seed_mask):
    """The NLL's mean over the valid seeds."""
    ll = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(seed_mask, labels, 0).long()
    nll = torch.where(seed_mask, -ll.gather(1, safe[:, None])[:, 0], 0.0)
    return nll.sum() / torch.clamp(seed_mask.sum(), min=1).float()


class Adam:
    """Adam with coupled L2: ``g = grad + wd * p``, then Adam's moments and
    bias corrections (Kingma and Ba, arXiv:1412.6980)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The updated parameters; the decayed gradients of this step are
        kept in ``self.g``."""
        self.t += 1
        self.g = {}
        out = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            self.g[k] = g
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            mhat = self.m[k] / (1 - self.b1**self.t)
            denom = self.v[k].sqrt() / (1 - self.b2**self.t) ** 0.5 + self.eps
            out[k] = p - self.lr * mhat / denom
        return out


def family(name: str):
    """The reference module of model family ``name``:
    ``gnnbench/reference/<name>.py``, with ``layer_dims``,
    ``param_shapes``, ``forward``, ``full``, ``train_flops`` and
    ``full_flops``."""
    return importlib.import_module(f"gnnbench.reference.{name}")


def train_step(cfg: Dict, params: Dict, blocks_in_first: List, x, labels, seed_mask, drop_keys: Sequence,
               q: Quant = identity):
    """``(loss, grads, logits)`` of one step at ``params``."""
    fam = family(cfg["model"]["family"])
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    with float32_exact():
        logits = fam.forward(leaves, blocks_in_first, x, drop_keys, cfg, q)
        loss = masked_nll(logits, labels, seed_mask)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.detach() for k, g in zip(leaves, grads)}, logits.detach().float()


@torch.no_grad()
def full(cfg: Dict, params: Dict, indptr, indices, x, q: Quant = identity):
    """The family's layer-wise pass over every node with its whole
    in-neighbourhood, in float32: [N, C]."""
    with float32_exact():
        return family(cfg["model"]["family"]).full(params, indptr, indices, x, cfg, q)


def edge_rows(indptr) -> torch.Tensor:
    """The destination row of every edge of a CSC."""
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), (indptr[1:] - indptr[:-1]).long())
