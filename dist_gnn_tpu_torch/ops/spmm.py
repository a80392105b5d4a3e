"""Block aggregation, plain PyTorch.

Counterpart of ``dist_gnn_tpu/ops/spmm.py``.  A block is a dense padded
``[S, k]`` slot table into the frontier feature matrix, so aggregation is a
gather and a masked reduction.  :func:`gather_mean` is the plain version of
the K3 kernel (``ops/gather.py``): CPU tensors take it, and the kernel is
held against it on the card.
"""

from __future__ import annotations

import torch


def gather_mean(
    h_src: torch.Tensor,  # [cap_src, F]
    slots: torch.Tensor,  # [S, k] int32 positions into h_src
    mask: torch.Tensor,  # [S, k] bool
) -> torch.Tensor:
    """Masked mean of neighbour features per destination row: [S, F].

    Zero-neighbour rows give zeros (DGL SAGEConv 'mean' on an empty
    neighbourhood).  Builds the [S, k, F] intermediate, in h's dtype."""
    g = h_src[slots.long()]  # [S, k, F]
    m = mask[..., None].to(h_src.dtype)
    s = torch.sum(g * m, dim=1)
    cnt = torch.sum(mask, dim=1, dtype=h_src.dtype)[:, None]
    return s / torch.clamp(cnt, min=1)
