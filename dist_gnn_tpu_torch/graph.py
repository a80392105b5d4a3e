"""Graph containers (CSC layout, in-neighbours).

Counterpart of ``dist_gnn_tpu/graph.py``.  :class:`HostGraph` is the numpy
host copy; :class:`Graph` holds ``indptr``/``indices`` (and, for a weighted
graph, ``probs`` and optionally the Walker alias tables ``alias_prob``/
``alias_idx``) as torch tensors on one device.  The JAX package's padded
edge arrays, ``alias_pack``, ``indptr_pairs`` and window pair layouts serve
TPU gathers and are not carried over: the port samples with the exact
elementwise fetch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device

# Padding sentinel for node ids.  Sorts after every valid id, so the
# sort-based relabel pushes padding to the tail.
INVALID_ID = np.iinfo(np.int32).max


def _min_indptr_dtype(num_edges: int):
    return np.int32 if num_edges < 2**31 else np.int64


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """CSC graph in host memory (numpy): row = destination, the stored
    neighbour list of a node is its in-neighbours."""

    indptr: np.ndarray  # [N+1], int32 below 2**31 edges, else int64
    indices: np.ndarray  # [nnz] int32
    probs: Optional[np.ndarray] = None  # [nnz] float32, unnormalised weights

    def __post_init__(self):
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr and indices must be 1-D")
        if self.probs is not None and self.probs.shape != self.indices.shape:
            raise ValueError("probs must be parallel to indices")

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        if self.num_nodes == 0:
            return 0
        return int(self.degrees.max())

    @staticmethod
    def from_coo(
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int,
        probs: Optional[np.ndarray] = None,
        symmetrize: bool = False,
    ) -> "HostGraph":
        """CSC (in-neighbour) graph from a directed edge list, by the
        native stable counting sort (``utils/native.build_csc``): within a
        row, edges keep their edge-list order, and ``indptr`` is int32
        below 2**31 edges, as the JAX package's native build gives."""
        from dist_gnn_tpu_torch.utils import native

        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if probs is not None:
                probs = np.concatenate([probs, probs])
        indptr, indices, out_probs = native.build_csc(dst, src, num_nodes, probs)
        return HostGraph(indptr=indptr, indices=indices, probs=out_probs)

    def build_alias_tables(self):
        """Walker alias tables of the weighted graph, ``(prob [E] f32,
        alias [E] int32 row offsets)``, by the native build
        (``utils/native.build_alias``); the alias sampler
        (``ops/sampling.sample_biased_alias``) draws from them."""
        if self.probs is None:
            raise ValueError("alias tables need a weighted graph (probs)")
        from dist_gnn_tpu_torch.utils import native

        return native.build_alias(self.indptr, self.probs)

    def to_device(self, device: DeviceLike = None, with_alias: bool = False) -> "Graph":
        """Upload ``indptr``/``indices`` (and ``probs``) to ``device``
        (default: the card); ``with_alias`` also builds and uploads the
        alias tables of a weighted graph, which makes its sampler the alias
        sampler (``ops/sampling.sample_neighbors``)."""
        dev = resolve_device(device)

        def put(a, dtype=None):
            # a read-only array (a memmap of a loaded dataset) is copied:
            # torch cannot share read-only memory
            return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(dev)

        alias_prob = alias_idx = None
        if with_alias and self.probs is not None:
            ap, ai = self.build_alias_tables()
            alias_prob, alias_idx = put(ap, np.float32), put(ai, np.int32)
        return Graph(
            indptr=put(self.indptr),
            indices=put(self.indices, np.int32),
            probs=None if self.probs is None else put(self.probs, np.float32),
            num_nodes=self.num_nodes,
            num_edges=self.num_edges,
            max_degree=self.max_degree,
            alias_prob=alias_prob,
            alias_idx=alias_idx,
        )


@dataclasses.dataclass(frozen=True)
class Graph:
    """Device-resident CSC graph."""

    indptr: torch.Tensor  # [N+1]
    indices: torch.Tensor  # [nnz] int32
    probs: Optional[torch.Tensor]
    num_nodes: int
    num_edges: int
    max_degree: int
    alias_prob: Optional[torch.Tensor] = None  # [nnz] f32 acceptance thresholds
    alias_idx: Optional[torch.Tensor] = None  # [nnz] int32 alias offsets within the row

    @property
    def has_probs(self) -> bool:
        return self.probs is not None

    def degrees_of(self, nids: torch.Tensor) -> torch.Tensor:
        """Degrees (int32) of possibly padded node ids; ``INVALID_ID``
        padding gets 0."""
        safe = torch.clamp(nids.long(), 0, self.num_nodes - 1)
        deg = (self.indptr[safe + 1] - self.indptr[safe]).to(torch.int32)
        return torch.where(nids == INVALID_ID, 0, deg)

    def edge_rows(self) -> torch.Tensor:
        """Row (destination) id of every edge, int32 [nnz]: the CSR expand
        of ``indptr``, ``searchsorted(indptr, e, right) - 1``."""
        e = torch.arange(self.num_edges, dtype=self.indptr.dtype, device=self.indptr.device)
        return (torch.searchsorted(self.indptr, e, right=True) - 1).to(torch.int32)
