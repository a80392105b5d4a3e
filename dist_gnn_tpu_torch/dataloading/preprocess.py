"""Synthetic datasets, as seeded numpy.

Counterpart of ``dist_gnn_tpu/dataloading/preprocess.py``
(``make_synthetic_dataset``, ``add_random_probs``).  The port keeps its own
copy: the arrays are equal to the JAX package's for the same arguments.
"""

from __future__ import annotations

import numpy as np

from dist_gnn_tpu_torch.graph import HostGraph


def add_random_probs(num_edges: int, seed: int = 0) -> np.ndarray:
    """``probs = |N(0,1)|`` per edge."""
    return np.abs(np.random.default_rng(seed).standard_normal(num_edges)).astype(
        np.float32
    )


def make_synthetic_dataset(
    num_nodes: int = 10_000,
    avg_degree: int = 15,
    feature_dim: int = 64,
    num_classes: int = 16,
    train_frac: float = 0.1,
    with_probs: bool = False,
    seed: int = 0,
    power: float = 0.8,
):
    """Power-law community graph whose labels are learnable from features
    and structure (features = class centroid + noise; ~70% of edges stay
    inside a community).  Returns ``(arrays, meta)``; the graph is
    symmetrized, so it holds about ``2 * num_nodes * avg_degree`` edges."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    # power-law hub endpoints via the inverse CDF of a Zipf-like law
    perm = rng.permutation(num_nodes)

    def zipf_nodes(count):
        u = rng.random(count)
        ranks = ((num_nodes ** (1 - power)) * u + (1 - u)) ** (1 / (1 - power))
        return perm[np.clip(ranks.astype(np.int64) - 1, 0, num_nodes - 1)]

    dst = zipf_nodes(num_edges)
    src = zipf_nodes(num_edges)
    # ~70% of edges stay intra-community: remap src to a same-label node
    same = rng.random(num_edges) < 0.7
    by_label = [np.flatnonzero(labels == c) for c in range(num_classes)]
    lab_dst = labels[dst]
    for c in range(num_classes):
        m = same & (lab_dst == c)
        cnt = int(m.sum())
        if cnt and len(by_label[c]):
            src[m] = by_label[c][rng.integers(0, len(by_label[c]), cnt)]
    graph = HostGraph.from_coo(src, dst, num_nodes, symmetrize=True)

    centroids = rng.standard_normal((num_classes, feature_dim)).astype(np.float32)
    features = (
        centroids[labels] + 1.5 * rng.standard_normal((num_nodes, feature_dim))
    ).astype(np.float32)

    perm = rng.permutation(num_nodes)
    n_train = int(num_nodes * train_frac)
    n_valid = int(num_nodes * 0.05)
    arrays = dict(
        indptr=graph.indptr,
        indices=graph.indices,
        features=features,
        labels=labels,
        train_idx=perm[:n_train].astype(np.int32),
        valid_idx=perm[n_train : n_train + n_valid].astype(np.int32),
        test_idx=perm[n_train + n_valid :].astype(np.int32),
    )
    if with_probs:
        arrays["probs"] = add_random_probs(graph.num_edges, seed)
    meta = dict(
        num_nodes=num_nodes,
        num_edges=graph.num_edges,
        feature_dim=feature_dim,
        num_classes=num_classes,
        name="synthetic",
    )
    return arrays, meta
