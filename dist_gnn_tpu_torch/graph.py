"""Graph containers (CSC layout, in-neighbours).

Counterpart of ``dist_gnn_tpu/graph.py``.  :class:`HostGraph` is the numpy
host copy; :class:`Graph` holds ``indptr``/``indices`` as torch tensors on
one device.  The JAX package's alias tables, pair layouts and windows serve
TPU gathers and are not carried over: the port samples with the exact
elementwise fetch, which needs only ``indptr`` and ``indices``.
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
        """CSC (in-neighbour) graph from a directed edge list.

        A stable counting sort by destination: within a row, edges keep
        their edge-list order.  That is what the JAX package's native
        C++ build and its numpy fallback both give, dtypes included (int32
        ``indptr`` below 2**31 edges)."""
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if probs is not None:
                probs = np.concatenate([probs, probs])
        src = np.asarray(src)
        dst = np.asarray(dst)
        if dst.size and (dst.min() < 0 or dst.max() >= num_nodes):
            raise ValueError(f"from_coo: dst ids outside [0, {num_nodes})")
        counts = np.bincount(dst, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        order = np.argsort(dst, kind="stable")
        indices = src[order].astype(np.int32)
        out_probs = probs[order].astype(np.float32) if probs is not None else None
        indptr = indptr.astype(_min_indptr_dtype(len(indices)))
        return HostGraph(indptr=indptr, indices=indices, probs=out_probs)

    def to_device(self, device: DeviceLike = None) -> "Graph":
        """Upload ``indptr``/``indices`` (and ``probs``) to ``device``
        (default: the card)."""
        dev = resolve_device(device)
        return Graph(
            indptr=torch.from_numpy(np.ascontiguousarray(self.indptr)).to(dev),
            indices=torch.from_numpy(
                np.ascontiguousarray(self.indices, dtype=np.int32)
            ).to(dev),
            probs=None
            if self.probs is None
            else torch.from_numpy(np.ascontiguousarray(self.probs, np.float32)).to(dev),
            num_nodes=self.num_nodes,
            num_edges=self.num_edges,
            max_degree=self.max_degree,
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

