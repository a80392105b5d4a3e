"""Full-graph layer-wise inference ("serving" over every node).

Counterpart of ``dist_gnn_tpu/models/inference.py::full_graph_inference``,
SAGE branch.  Each layer is evaluated over all nodes with their full
neighbourhoods, one layer at a time, so the result carries no sampling
noise.

Per layer the edges are walked in fixed chunks of the CSC edge array.  A
chunk's source rows are gathered through K1 and summed into their
destination rows with ``index_add_`` in f32, keyed by the edge→row map
computed once per call.  ``h[indices]`` is never built for the whole
graph: at 30M edges and width 256 in bf16 it would take 15 GB.  The JAX
package bounds each chunk's destination span too (``node_chunk``), so its
one-hot segment sum fits TPU memory; a scatter-add has no such limit, so
the port keeps only the edge bound.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import HostGraph
from dist_gnn_tpu_torch.models.sage import SAGE
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def _edge_rows(indptr: torch.Tensor, num_nodes: int, nnz: int) -> torch.Tensor:
    """Destination row of every edge [nnz] (int64): the CSR expansion of
    ``indptr`` (the known ``nnz`` spares a device-to-host size read)."""
    deg = indptr[1:] - indptr[:-1]
    rows = torch.arange(num_nodes, dtype=torch.int64, device=indptr.device)
    return torch.repeat_interleave(rows, deg, output_size=nnz)


@torch.inference_mode()
def full_graph_inference(
    model,
    params: Optional[Mapping[str, torch.Tensor]],
    hg: HostGraph,
    features: torch.Tensor,
    edge_chunk: int = 1 << 18,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Layer-wise full-neighbourhood forward; returns the final layer's
    output [N, C] on ``device`` (default: the card).

    ``params`` (a state_dict) overrides the model's own weights when
    given.  Only SAGE is ported; GAT and GCN raise."""
    if not isinstance(model, SAGE):
        raise NotImplementedError(
            f"full_graph_inference: {type(model).__name__} is not ported yet "
            "(GAT and GCN come in later slices)"
        )
    dev = resolve_device(device)
    N = hg.num_nodes
    nnz = hg.num_edges
    indptr = torch.from_numpy(np.asarray(hg.indptr, dtype=np.int64)).to(dev)
    indices = torch.from_numpy(np.asarray(hg.indices, dtype=np.int32)).to(dev)
    erows = _edge_rows(indptr, N, nnz)
    deg = (indptr[1:] - indptr[:-1]).to(torch.float32)

    h = features.to(dev)
    for l in range(len(model.dims)):
        acc = torch.zeros((N, h.shape[1]), dtype=torch.float32, device=dev)
        for b0 in range(0, nnz, edge_chunk):
            b1 = min(b0 + edge_chunk, nnz)
            msg = gather_rows(h, indices[b0:b1])  # K1
            acc.index_add_(0, erows[b0:b1], msg.float())
        h_mean = (acc / torch.clamp(deg, min=1)[:, None]).to(h.dtype)
        p = model.layer_params(l)
        p = {
            name: (p[name] if params is None else params[f"layer{l}.{name}"]).to(dev)
            for name in ("w_self", "w_neigh", "b")
        }
        h = model._layer_forward(p, h, h_mean)
        if l != len(model.dims) - 1:
            h = torch.relu(h)
    return h
