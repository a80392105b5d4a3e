"""Distributed full-graph layer-wise inference: activations sharded by
node range, blocks rotated around a ring.

Counterpart of ``dist_gnn_tpu/parallel/inference_dist.py``.  Rank ``d``
holds the activations of rows ``[d*S, (d+1)*S)``.  Per layer, for
``t = 0 .. D-1`` every rank sums the in-edges whose source lies in the
block it holds (owner ``(d + t) % D``) into its own rows, then passes the
block one step around the ring (``Mesh.shift``: a send to rank ``d - 1``
and a receive from ``d + 1``, the JAX package's ``ppermute``); the block
is not passed after the last step.  Cross-rank traffic is ``D - 1``
contiguous blocks per layer.  A two-tier ``('host', 'data')`` mesh runs
its ring over the flat world (rank order), as the JAX package re-flattens
any mesh.

Each rotation's edge walk is the single-device walk's
(``models/inference.py``): K1 gathers of the held block in chunks of
``edge_chunk`` edges, summed into the destination rows with ``index_add_``
in f32.  SAGE divides by the full-graph degree, GCN scales its source
rows by ``1/sqrt(deg+1)`` before they travel, and GAT folds every slab
into its running softmax (``_gat_online``), exact across rotations and
chunks.  Each rank builds its own edge buckets on its device (a stable
sort of its in-edges by the owner of their source) and pads none (the
JAX package pads every bucket to one static length on the host).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from dist_gnn_tpu_torch.graph import HostGraph
from dist_gnn_tpu_torch.models.gat import GAT
from dist_gnn_tpu_torch.models.gcn import GCN
from dist_gnn_tpu_torch.models.inference import (
    _check_model,
    _edge_sum,
    _gat_online,
    _inv_sqrt_deg,
    _layer_params,
)
from dist_gnn_tpu_torch.ops.gather import gather_rows
from dist_gnn_tpu_torch.parallel.mesh import Mesh


def _ring_buckets(hg: HostGraph, D: int, rank: int, S: int,
                  device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Rank ``rank``'s in-edges sorted (stably) by the owner of their
    source and split per owner: ``[(src row in the owner's block [E_o]
    int32, destination row [E_o] int64)] * D``, built on ``device``."""
    indptr = np.asarray(hg.indptr, np.int64)
    lo_n, hi_n = min(rank * S, hg.num_nodes), min((rank + 1) * S, hg.num_nodes)
    src = torch.from_numpy(np.asarray(hg.indices[indptr[lo_n] : indptr[hi_n]])).to(device).long()
    deg = torch.from_numpy(np.diff(indptr[lo_n : hi_n + 1])).to(device)
    dst_row = torch.repeat_interleave(torch.arange(hi_n - lo_n, device=device), deg, output_size=src.shape[0])
    owner = torch.div(src, S, rounding_mode="floor")
    order = torch.sort(owner, stable=True).indices
    src, dst_row, owner = src[order], dst_row[order], owner[order]
    counts = torch.bincount(owner, minlength=D).tolist()
    return [((s_ - o * S).to(torch.int32), d_) for o, (s_, d_) in
            enumerate(zip(torch.split(src, counts), torch.split(dst_row, counts)))]


def build_ring_layout(hg: HostGraph, D: int, edge_chunk: int):
    """The JAX package's padded ring layout (inference_dist.py:47-97):
    ``(S, E_pad, src_local [D, D, E], dst_row [D, D, E], valid [D, D, E],
    deg [D*S])``, bucket ``[d, o]`` holding device d's in-edges whose source
    block is o's, src as a row of that block, each bucket padded to the
    largest rounded up to ``edge_chunk``.  The buckets are the ones
    ``dist_full_graph_inference`` walks, built on the CPU; the ring itself
    walks them unpadded."""
    N = hg.num_nodes
    S = (N + D - 1) // D
    per_dev = [_ring_buckets(hg, D, d, S, torch.device("cpu")) for d in range(D)]
    e_max = max(src.shape[0] for buckets in per_dev for src, _ in buckets)
    E = max(edge_chunk, -(-e_max // edge_chunk) * edge_chunk)
    src_local = np.zeros((D, D, E), np.int32)
    dst_rows = np.zeros((D, D, E), np.int32)
    valid = np.zeros((D, D, E), bool)
    for d, buckets in enumerate(per_dev):
        for o, (src, dst_row) in enumerate(buckets):
            c = src.shape[0]
            src_local[d, o, :c] = src.numpy()
            dst_rows[d, o, :c] = dst_row.numpy()
            valid[d, o, :c] = True
    indptr = np.asarray(hg.indptr)
    deg = np.zeros((D * S,), np.float32)
    deg[:N] = (indptr[1:] - indptr[:-1]).astype(np.float32)
    return S, E, src_local, dst_rows, valid, deg


def _ring_sum(v: torch.Tensor, buckets, mesh: Mesh, edge_chunk: int) -> torch.Tensor:
    """sum over this rank's in-edges of ``v[src]`` (``v`` the [S, F] blocks
    as they come round the ring), per destination row, in f32."""
    acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t in range(mesh.size):
        src, dst = buckets[(mesh.rank + t) % mesh.size]
        _edge_sum(v, src, dst, edge_chunk, acc)
        if t < mesh.size - 1:
            v = mesh.shift(v)
    return acc


def _ring_gat(z, el, er, buckets, mesh: Mesh, edge_chunk: int, negative_slope: float, H: int, d: int):
    """GAT's softmax-weighted sum over this rank's in-edges, the (z, er)
    blocks rotating around the ring: [S, H, d] f32, 0 on rows without an
    in-edge."""
    S = z.shape[0]
    m = torch.full((S, H), -1e30, dtype=torch.float32, device=z.device)
    s = torch.zeros((S, H), dtype=torch.float32, device=z.device)
    acc = torch.zeros((S, H, d), dtype=torch.float32, device=z.device)
    for t in range(mesh.size):
        src, dst = buckets[(mesh.rank + t) % mesh.size]
        for b0 in range(0, src.shape[0], edge_chunk):
            sc, rows = src[b0 : b0 + edge_chunk], dst[b0 : b0 + edge_chunk]
            m, s, acc = _gat_online(m, s, acc, el[rows], er[sc.long()], gather_rows(z, sc), rows, negative_slope)
        if t < mesh.size - 1:
            z, er = mesh.shift(z), mesh.shift(er)
    return acc / torch.clamp(s, min=1e-12)[:, :, None]


@torch.inference_mode()
def dist_full_graph_inference(
    model,
    params: Optional[Mapping[str, torch.Tensor]],
    hg: HostGraph,
    features,
    mesh: Mesh,
    edge_chunk: int = 1 << 18,
) -> torch.Tensor:
    """Layer-wise full-neighbourhood forward of a SAGE, GCN or GAT model
    with node-range-sharded activations; every rank calls it with the same
    host graph and features and gets the whole [N, C] output on its device
    (one all-gather at the end).  ``params`` (a state_dict) overrides the
    model's own weights.  Each family casts where the single-device
    ``full_graph_inference`` does."""
    _check_model(model, "dist_full_graph_inference")
    dev = mesh.device
    N, D, me = hg.num_nodes, mesh.size, mesh.rank
    S = (N + D - 1) // D
    lo, hi = min(me * S, N), min((me + 1) * S, N)
    feats = features if isinstance(features, torch.Tensor) else torch.from_numpy(np.asarray(features))
    h = torch.zeros((S, feats.shape[1]), dtype=feats.dtype, device=dev)
    h[: hi - lo] = feats[lo:hi].to(dev)
    indptr = np.asarray(hg.indptr, np.int64)
    deg_np = np.zeros(S, np.float32)
    deg_np[: hi - lo] = indptr[lo + 1 : hi + 1] - indptr[lo:hi]
    deg = torch.from_numpy(deg_np).to(dev)
    buckets = _ring_buckets(hg, D, me, S, dev)
    if isinstance(model, GCN):
        inv_sqrt = _inv_sqrt_deg(deg).to(h.dtype)
    for l in range(len(model.dims)):
        p = _layer_params(model, params, l, dev)
        last = l == len(model.dims) - 1
        if isinstance(model, GAT):
            d_out, H = model.dims[l][1], model.num_heads
            z, el, er = model._project(p, h, d_out)
            agg = _ring_gat(z, el, er, buckets, mesh, edge_chunk, model.negative_slope, H, d_out)
            h = model._combine(p, agg.to(z.dtype), d_out, last)
            continue
        if isinstance(model, GCN):
            ssum = _ring_sum(h * inv_sqrt[:, None], buckets, mesh, edge_chunk)
            agg = ssum.to(h.dtype) * inv_sqrt[:, None] + h / (deg.to(h.dtype) + 1)[:, None]
            h = model._layer_forward(p, agg, agg.dtype)
        else:
            ssum = _ring_sum(h, buckets, mesh, edge_chunk)
            h = model._layer_forward(p, h, (ssum / torch.clamp(deg, min=1)[:, None]).to(h.dtype))
        if not last:
            h = torch.relu(h)
    return torch.cat(mesh.all_gather(h))[:N]
