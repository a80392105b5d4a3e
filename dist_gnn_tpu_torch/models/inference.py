"""Full-graph layer-wise inference ("serving" over every node).

Counterpart of ``dist_gnn_tpu/models/inference.py``: each layer is
evaluated over all nodes with their full neighbourhoods, one layer at a
time, so the result carries no sampling noise.  All three model families:
SAGE (mean), GCN (symmetric norm with the true full-graph degrees) and GAT
(exact softmax over every in-edge).

:func:`full_graph_inference` keeps the graph, the features and every
layer's activations on the device.  SAGE and GCN walk each layer's edges
in one call of K3-csr (``ops/gather.gather_mean_csr``): every row's CSC
in-edges summed in f32 and written once, the mean's division (SAGE) before
the one rounding, with the heavy rows planned once a pass (``csr_plan``).
GAT walks the edges in fixed chunks of the CSC edge array, keyed by the
edge→row map computed once per call, two walks per layer over the
projected table: the row maximum of ``leaky_relu(el[dst] + er[src])``
comes from a ``scatter_reduce_("amax")`` of the cheap [E, H] ``er[src]``
(leaky_relu is monotone), then a second walk gathers ``z[src]`` through K1
and adds ``w`` and ``w * z[src]``, w = exp(score - max), into f32 sums with
``index_add_``, and one division ends the exact softmax.  An edge chunk may
split a row: both walks add across chunks.  ``h[indices]`` or
``z[indices]`` is never built for the whole graph: at 30M edges and 512
bf16 columns that would be 30 GB.  The JAX package's span plan, one-hot
band matmuls and head expander shape its walks to the TPU and are not
carried over.

:func:`full_graph_inference_host` keeps features and activations in host
memory (numpy, or an ``np.memmap``); nothing of shape [N, *] reaches the
device.  Per destination chunk, each edge slab's source rows are gathered
on the host by the native OpenMP gather (``utils/native.gather_rows``)
into one of two reused buffers (``utils/staging.PinnedRing``, pinned when
the device is the card), copied with ``non_blocking=True``, and the
device accumulates: the
sum for SAGE, the sum of rows scaled by ``1/sqrt(deg+1)`` for GCN, and the
online (max-rescaled) softmax across slabs for GAT.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dist_gnn_tpu_torch.graph import HostGraph
from dist_gnn_tpu_torch.models.gat import GAT
from dist_gnn_tpu_torch.models.gcn import GCN
from dist_gnn_tpu_torch.models.sage import SAGE
from dist_gnn_tpu_torch.ops.gather import csr_plan, gather_mean_csr, gather_rows
from dist_gnn_tpu_torch.utils import native, trace
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device
from dist_gnn_tpu_torch.utils.staging import PinnedRing


def _edge_rows(indptr: torch.Tensor, num_nodes: int, nnz: int) -> torch.Tensor:
    """Destination row of every edge [nnz] (int64): the CSR expansion of
    ``indptr`` (the known ``nnz`` spares a device-to-host size read)."""
    deg = indptr[1:] - indptr[:-1]
    rows = torch.arange(num_nodes, dtype=torch.int64, device=indptr.device)
    return torch.repeat_interleave(rows, deg, output_size=nnz)


def _check_model(model, caller: str) -> None:
    if not isinstance(model, (SAGE, GCN, GAT)):
        raise NotImplementedError(f"{caller}: {type(model).__name__} is not a SAGE, GCN or GAT model")


def _layer_params(model, params: Optional[Mapping[str, torch.Tensor]], l: int, dev) -> dict:
    """Layer ``l``'s weights on ``dev``: the model's own, or ``params``
    (a state_dict) when given."""
    own = model.layer_params(l)
    return {name: (own[name] if params is None else params[f"layer{l}.{name}"]).to(dev) for name in own}


def _inv_sqrt_deg(deg: torch.Tensor) -> torch.Tensor:
    """GCN's norm with the true full-graph degrees, ``1/sqrt(deg+1)`` in f32
    (the sampled blocks use slot counts instead)."""
    return 1.0 / torch.sqrt(deg.to(torch.float32) + 1)


def _edge_sum(h, indices, erows, edge_chunk, acc=None):
    """sum over in-edges of h[src], per destination row, in f32 [N, F]:
    a fresh sum, or added into ``acc``."""
    if acc is None:
        acc = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    for b0 in range(0, indices.shape[0], edge_chunk):
        msg = gather_rows(h, indices[b0 : b0 + edge_chunk])  # K1
        acc.index_add_(0, erows[b0 : b0 + edge_chunk], msg.float())
    return acc


def _gat_aggregate(z, el, er, indices, erows, edge_chunk, negative_slope, H, d):
    """Exact edge softmax of ``leaky_relu(el[dst] + er[src])`` per row and
    head, and the weighted sum of z[src]: [N, H, d] f32, rows with no
    in-edge all 0."""
    N = z.shape[0]
    er_max = torch.full((N, H), float("-inf"), dtype=torch.float32, device=z.device)
    for b0 in range(0, indices.shape[0], edge_chunk):
        rows = erows[b0 : b0 + edge_chunk]
        er_max.scatter_reduce_(
            0, rows[:, None].expand(-1, H), er[indices[b0 : b0 + edge_chunk].long()], "amax"
        )
    row_max = F.leaky_relu(el + er_max, negative_slope)  # -inf on rows with no edge
    denom = torch.zeros((N, H), dtype=torch.float32, device=z.device)
    acc = torch.zeros((N, H * d), dtype=torch.float32, device=z.device)
    for b0 in range(0, indices.shape[0], edge_chunk):
        src = indices[b0 : b0 + edge_chunk]
        rows = erows[b0 : b0 + edge_chunk]
        score = F.leaky_relu(el[rows] + er[src.long()], negative_slope)
        w = torch.exp(score - row_max[rows])  # [E, H]
        denom.index_add_(0, rows, w)
        zs = gather_rows(z, src).float().reshape(-1, H, d)  # K1
        acc.index_add_(0, rows, (zs * w[:, :, None]).reshape(-1, H * d))
    agg = acc.reshape(N, H, d) / denom[:, :, None]
    return torch.where(denom[:, :, None] > 0, agg, 0.0)


def _gat_online(m, s, acc, el_dst, er_src, z_src, rows, negative_slope):
    """Fold one slab of edges into GAT's running per-row, per-head softmax
    state: the maximum ``m`` [N, H], the sum ``s`` of ``exp(score - m)`` and
    the weighted sum ``acc`` [N, H, d] of the source rows, each rescaled when
    the maximum grows.  ``el_dst``/``er_src`` [E, H] f32 are the slab's
    destination and source scores, ``z_src`` [E, H*d] its projected source
    rows, ``rows`` [E] their destination rows.  Returns ``(m, s, acc)``."""
    H, d = acc.shape[1], acc.shape[2]
    score = F.leaky_relu(el_dst + er_src, negative_slope)
    m_new = m.scatter_reduce(0, rows[:, None].expand(-1, H), score, "amax")
    scale = torch.exp(m - m_new)
    w = torch.exp(score - m_new[rows])
    s = s * scale
    s.index_add_(0, rows, w)
    acc = acc * scale[:, :, None]
    acc.index_add_(0, rows, w[:, :, None] * z_src.float().reshape(-1, H, d))
    return m_new, s, acc


@torch.inference_mode()
def full_graph_inference(
    model,
    params: Optional[Mapping[str, torch.Tensor]],
    hg: HostGraph,
    features: torch.Tensor,
    edge_chunk: int = 1 << 18,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Layer-wise full-neighbourhood forward of a SAGE, GCN or GAT model;
    returns the final layer's output [N, C] on ``device`` (default: the
    card).

    ``params`` (a state_dict) overrides the model's own weights when
    given.  ``edge_chunk`` bounds the edges of one gather of GAT's walks and
    of the CPU's (K3-csr's plain version).  Each family
    casts where the JAX package's does: SAGE through ``_layer_forward`` in
    the compute dtype; GCN in h's dtype (the neighbour sum in f32, the
    product in h's dtype, the bias added in f32); GAT through
    ``_project`` and ``_combine``, whose f32 bias promotes every layer
    after the first to f32, as in JAX.  Any other model raises
    ``NotImplementedError``.

    The pass is the span ``infer_pass`` of ``utils/trace``; inside it
    ``infer.upload`` (the graph and features to the device; the heavy-row
    plan for SAGE and GCN, GCN's degrees, GAT's edge rows) and, per layer
    (attr ``layer``), ``infer.edge_walk`` (K3-csr and GCN's norm, or GAT's
    chunk loops) and ``infer.dense`` (the layer's products and the ReLU;
    GAT's projection and its combine are one each).  SAGE and GCN count,
    per layer, the edges walked (``infer.walk_edges``) and the heavy rows'
    rows and edges (``infer.walk_heavy_rows``, ``infer.walk_heavy_edges``,
    0-d tensors of the plan)."""
    _check_model(model, "full_graph_inference")
    with trace.span("infer_pass"):
        dev = resolve_device(device)
        N = hg.num_nodes
        nnz = hg.num_edges
        is_gat = isinstance(model, GAT)
        with trace.span("infer.upload"):
            indptr = torch.from_numpy(np.asarray(hg.indptr, dtype=np.int64)).to(dev)
            indices = torch.from_numpy(np.asarray(hg.indices, dtype=np.int32)).to(dev)
            h = features.to(dev)
            if is_gat:
                erows = _edge_rows(indptr, N, nnz)
            else:
                plan = csr_plan(indptr, nnz)
            if isinstance(model, GCN):
                deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
                inv_sqrt = _inv_sqrt_deg(deg).to(h.dtype)
        for l in range(len(model.dims)):
            p = _layer_params(model, params, l, dev)
            last = l == len(model.dims) - 1
            if is_gat:
                d_out, H = model.dims[l][1], model.num_heads
                with trace.span("infer.dense", layer=l):
                    z, el, er = model._project(p, h, d_out)
                with trace.span("infer.edge_walk", layer=l):
                    agg = _gat_aggregate(z, el, er, indices, erows, edge_chunk, model.negative_slope, H, d_out)
                with trace.span("infer.dense", layer=l):
                    h = model._combine(p, agg.to(z.dtype), d_out, last)
                continue
            trace.count("infer.walk_edges", nnz)
            trace.count("infer.walk_heavy_rows", plan.n_heavy)
            trace.count("infer.walk_heavy_edges", plan.heavy_edges)
            if isinstance(model, GCN):
                # each source row scaled once per layer, in h's dtype: the same
                # products as scaling every gathered edge row
                with trace.span("infer.edge_walk", layer=l):
                    ssum = gather_mean_csr(h * inv_sqrt[:, None], indptr, indices, False, plan, edge_chunk)
                    agg = ssum * inv_sqrt[:, None] + h / (deg.to(h.dtype) + 1)[:, None]
                with trace.span("infer.dense", layer=l):
                    h = model._layer_forward(p, agg, agg.dtype)
                    if not last:
                        h = torch.relu(h)
            else:
                with trace.span("infer.edge_walk", layer=l):
                    h_mean = gather_mean_csr(h, indptr, indices, True, plan, edge_chunk)
                with trace.span("infer.dense", layer=l):
                    h = model._layer_forward(p, h, h_mean)
                    if not last:
                        h = torch.relu(h)
        return h


@torch.inference_mode()
def full_graph_inference_host(
    model,
    params: Optional[Mapping[str, torch.Tensor]],
    hg: HostGraph,
    host_features: np.ndarray,
    node_chunk: int = 4096,
    edge_chunk: int = 1 << 14,
    device: DeviceLike = None,
) -> np.ndarray:
    """Full-graph layer-wise inference with features and activations in
    host memory; returns [N, C] float32 numpy (inference.py:103-217).

    Per destination chunk of ``node_chunk`` rows: the chunk's own rows go
    to the device in f32; its in-edges are walked in slabs of at most
    ``edge_chunk`` edges whose source rows are gathered on the host
    (``native.gather_rows`` into a reused buffer), copied to the device
    and accumulated there, with state of O(node_chunk * F + edge_chunk * F)
    only.  SAGE divides the sum by max(deg, 1) (``_acc_sum_slab``); GCN
    scales each source row by ``1/sqrt(deg+1)`` on the host and the sum by
    the destination's on the device, with the true degrees; GAT projects
    each slab and folds it into a running (max, sum, weighted sum) per row
    and head (``_gat_acc_slab``), exact across slabs.  Rows with no
    in-edge get a zero aggregate."""
    _check_model(model, "full_graph_inference_host")
    dev = resolve_device(device)
    N = hg.num_nodes
    indptr = np.asarray(hg.indptr, np.int64)
    indices = torch.from_numpy(np.asarray(hg.indices, np.int64))
    deg = np.diff(indptr)
    inv_sqrt = _inv_sqrt_deg(torch.from_numpy(deg))
    is_gat, is_gcn = isinstance(model, GAT), isinstance(model, GCN)
    ring = PinnedRing(dev)
    h_host = torch.from_numpy(np.ascontiguousarray(host_features, dtype=np.float32))  # no copy for f32
    for l in range(len(model.dims)):
        p = _layer_params(model, params, l, dev)
        last = l == len(model.dims) - 1
        width = h_host.shape[1]
        d_out = model.dims[l][1]
        out_dim = d_out * (1 if (last or not is_gat) else model.num_heads)
        out_host = np.empty((N, out_dim), np.float32)
        for lo in range(0, N, node_chunk):
            num = min(node_chunk, N - lo)
            e_lo, e_hi = int(indptr[lo]), int(indptr[lo + num])
            rows_chunk = torch.from_numpy(np.repeat(np.arange(num), deg[lo : lo + num])).to(dev)
            h_self = h_host[lo : lo + num].to(dev)
            if is_gat:
                H = model.num_heads
                _, el_self, _ = model._project(p, h_self, d_out)
                m = torch.full((num, H), -1e30, dtype=torch.float32, device=dev)
                s = torch.zeros((num, H), dtype=torch.float32, device=dev)
                acc = torch.zeros((num, H, d_out), dtype=torch.float32, device=dev)
            else:
                acc = torch.zeros((num, width), dtype=torch.float32, device=dev)
            for b0 in range(e_lo, e_hi, edge_chunk):
                n = min(edge_chunk, e_hi - b0)
                i = ring.acquire()
                src = indices[b0 : b0 + n]
                buf = ring.buffer(i, "rows", (n, width), torch.float32)
                native.gather_rows(h_host.numpy(), src.numpy(), out=buf.numpy())
                if is_gcn:
                    buf.mul_(inv_sqrt[src, None])
                msg = buf.to(dev, non_blocking=True)
                ring.release(i)
                rows = rows_chunk[b0 - e_lo : b0 - e_lo + n]
                if is_gat:
                    z_src, _, er_src = model._project(p, msg, d_out)
                    m, s, acc = _gat_online(m, s, acc, el_self[rows], er_src, z_src, rows, model.negative_slope)
                else:
                    acc.index_add_(0, rows, msg)
            if is_gat:
                agg = acc / torch.clamp(s, min=1e-12)[:, :, None]
                out = model._combine(p, agg, d_out, last)
            elif is_gcn:
                inv_dst = inv_sqrt[lo : lo + num].to(dev)[:, None]
                agg = acc * inv_dst + h_self * inv_dst**2
                out = model._layer_forward(p, agg, agg.dtype)
            else:
                h_mean = acc / torch.from_numpy(np.maximum(deg[lo : lo + num], 1).astype(np.float32)).to(dev)[:, None]
                out = model._layer_forward(p, h_self, h_mean)
            if not is_gat and not last:
                out = torch.relu(out)
            out_host[lo : lo + num] = out.float().cpu().numpy()
        h_host = torch.from_numpy(out_host)
    return h_host.numpy()
