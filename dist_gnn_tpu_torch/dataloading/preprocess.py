"""Dataset preprocessing: the on-disk layout, OGB ingestion and synthetic
generators, as seeded numpy.

Counterpart of ``dist_gnn_tpu/dataloading/preprocess.py``; the port keeps
its own copy, and every function gives the JAX package's arrays for the
same arguments:

  * :func:`save_dataset` / :func:`load_dataset`: one directory per
    dataset, one ``.npy`` per array (``indptr``, ``indices``,
    ``features``, ``labels``, ``train_idx``, ``valid_idx``, ``test_idx``
    and the optional ``probs``) and ``metadata.json``, so a dataset saved
    by either package loads in the other; ``mmap=True`` gives read-only
    memmaps;
  * CSC of the directed graph with dst-as-row (in-neighbours);
    ogbn-products is symmetrized first, papers100M is not;
  * optional per-edge sampling weights ``probs = |N(0,1)|``;
  * :func:`replicate_graph`: papers400M-style synthesis by k-fold
    replication with random inter-copy rewiring and ring links;
  * :func:`process_ogb_raw`: a raw OGB download read with ``gzip`` and
    numpy (no pandas, no ``ogb`` package);
  * :func:`make_synthetic_dataset`: power-law graphs with learnable
    community structure, so end-to-end accuracy is testable offline.

Everything here runs on the host; no function places anything on a device.

One command ingests a raw OGB download:

    python -m dist_gnn_tpu_torch.dataloading.preprocess --ogb-raw <dir> \\
        --name ogbn-products --out <root> [--with-probs]

It prints the dataset's metadata as one JSON line.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict

import numpy as np

from dist_gnn_tpu_torch.graph import HostGraph

_ARRAYS = ("indptr", "indices", "features", "labels", "train_idx", "valid_idx", "test_idx")
_OPTIONAL = ("probs",)


def save_dataset(root: str, name: str, arrays: Dict[str, np.ndarray], meta: Dict) -> None:
    """Write ``arrays`` (one ``<key>.npy`` each) and ``meta``
    (``metadata.json``) under ``root/name``."""
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    for k, v in arrays.items():
        np.save(os.path.join(path, f"{k}.npy"), v)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)


def load_dataset(root: str, name: str, mmap: bool = True):
    """``(arrays, meta)`` of ``root/name``: every array of the layout that
    is present, as read-only memmaps with ``mmap`` (copy one before handing
    it to torch, which cannot share read-only memory), else in memory."""
    path = os.path.join(root, name)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    arrays = {}
    for k in _ARRAYS + _OPTIONAL:
        fp = os.path.join(path, f"{k}.npy")
        if os.path.exists(fp):
            arrays[k] = np.load(fp, mmap_mode="r" if mmap else None)
    return arrays, meta


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


def replicate_graph(indptr: np.ndarray, indices: np.ndarray, copies: int, seed: int = 0):
    """papers400M-style synthesis: ``copies`` disjoint copies of the graph;
    each copied edge jumps to a random copy with probability 0.01, and a
    ring links node i of copy c to node (i + 1) mod n of copy c + 1, so the
    copies stay connected.  Returns ``(indptr, indices)``, equal to the JAX
    package's for the same seed."""
    rng = np.random.default_rng(seed)
    n = len(indptr) - 1
    nnz = len(indices)
    out_src = []
    out_dst = []
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for c in range(copies):
        src_c = indices.astype(np.int64) + c * n
        dst_c = rows + c * n
        jump = rng.random(nnz) < 0.01
        target_copy = rng.integers(0, copies, nnz)
        src_c = np.where(jump, indices.astype(np.int64) + target_copy * n, src_c)
        out_src.append(src_c)
        out_dst.append(dst_c)
        ring = np.arange(n, dtype=np.int64)
        out_src.append(ring + c * n)
        out_dst.append(((ring + 1) % n) + ((c + 1) % copies) * n)
    g = HostGraph.from_coo(np.concatenate(out_src), np.concatenate(out_dst), n * copies)
    return g.indptr, g.indices


def _csv_gz(path: str, dtype) -> np.ndarray:
    """A headerless comma-separated ``.csv.gz`` as a 2-D array of ``dtype``.
    Integer files parse as int64 and the rest as float64, the types
    pandas' ``read_csv`` gives them."""
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def process_ogb_raw(dataset_path: str, name: str, out_root: str, with_probs: bool = False):
    """Raw OGB download → this layout, from the files the reference
    preprocessing reads:

      * ogbn-products: ``raw/edge.csv.gz``, ``raw/node-feat.csv.gz``,
        ``raw/node-label.csv.gz``, ``split/sales_ranking/{train,valid,
        test}.csv.gz``; the graph is symmetrized;
      * ogbn-papers100M: ``raw/data.npz`` (``node_feat``, ``edge_index``),
        ``raw/node-label.npz`` (``node_label``), ``split/time/*.csv.gz``;
        not symmetrized, nan labels → 0.

    Edges and splits stay integers, features become float32, labels pass
    through ``nan_to_num`` to int32, and ``num_classes`` is the largest
    label plus one.  Saves the dataset under ``out_root/name`` and returns
    ``(arrays, meta)``."""
    if name == "ogbn-products":
        edges = _csv_gz(os.path.join(dataset_path, "raw/edge.csv.gz"), np.int64).T
        features = _csv_gz(os.path.join(dataset_path, "raw/node-feat.csv.gz"), np.float64).astype(np.float32)
        labels = _csv_gz(os.path.join(dataset_path, "raw/node-label.csv.gz"), np.int64).T[0]
        split_dir = "split/sales_ranking"
        src, dst = edges[0], edges[1]
        symmetrize = True
    elif name == "ogbn-papers100M":
        with np.load(os.path.join(dataset_path, "raw/data.npz")) as data_file:
            features = data_file["node_feat"].astype(np.float32)
            edge_index = data_file["edge_index"]
        with np.load(os.path.join(dataset_path, "raw/node-label.npz")) as label_file:
            labels = label_file["node_label"].reshape(-1)
        src, dst = edge_index[0], edge_index[1]
        split_dir = "split/time"
        symmetrize = False
    else:
        raise ValueError(f"unknown raw OGB dataset {name!r}")
    n = features.shape[0]
    splits = {
        k: _csv_gz(os.path.join(dataset_path, split_dir, f"{k}.csv.gz"), np.int64).T[0].astype(np.int32)
        for k in ("train", "valid", "test")
    }
    g = HostGraph.from_coo(src, dst, n, symmetrize=symmetrize)
    arrays = dict(
        indptr=g.indptr,
        indices=g.indices,
        features=features,
        labels=np.nan_to_num(labels).astype(np.int32),
        train_idx=splits["train"],
        valid_idx=splits["valid"],
        test_idx=splits["test"],
    )
    if with_probs:
        arrays["probs"] = add_random_probs(g.num_edges)
    meta = dict(
        num_nodes=int(n),
        num_edges=int(g.num_edges),
        feature_dim=int(features.shape[1]),
        num_classes=int(arrays["labels"].max()) + 1,
        name=name,
    )
    save_dataset(out_root, name, arrays, meta)
    return arrays, meta


def make_ogb_raw_fixture(dataset_path: str, name: str, seed: int = 0, n: int = 40):
    """Write a miniature of the raw OGB layout (the files, keys and
    compression :func:`process_ogb_raw` reads) for offline tests of the
    ingestion.  Returns the source COO, features, labels and splits."""
    rng = np.random.default_rng(seed)
    deg = 4
    src = rng.integers(0, n, n * deg).astype(np.int64)
    dst = rng.integers(0, n, n * deg).astype(np.int64)
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.float64)
    perm = rng.permutation(n)
    split = {
        "train": np.sort(perm[: n // 2]),
        "valid": np.sort(perm[n // 2 : 3 * n // 4]),
        "test": np.sort(perm[3 * n // 4 :]),
    }

    def _write_csv_gz(path, mat):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            for row in np.atleast_2d(mat):
                f.write(",".join(str(x) for x in np.atleast_1d(row)) + "\n")

    raw = os.path.join(dataset_path, "raw")
    os.makedirs(raw, exist_ok=True)
    if name == "ogbn-products":
        _write_csv_gz(os.path.join(raw, "edge.csv.gz"), np.stack([src, dst], 1))
        _write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), feats)
        _write_csv_gz(os.path.join(raw, "node-label.csv.gz"), labels[:, None].astype(np.int64))
        sd = os.path.join(dataset_path, "split/sales_ranking")
    elif name == "ogbn-papers100M":
        labels = labels.copy()
        labels[split["test"]] = np.nan  # papers100M: unlabeled nodes are nan
        np.savez(os.path.join(raw, "data.npz"), node_feat=feats, edge_index=np.stack([src, dst], 0))
        np.savez(os.path.join(raw, "node-label.npz"), node_label=labels)
        sd = os.path.join(dataset_path, "split/time")
    else:
        raise ValueError(name)
    for k, v in split.items():
        _write_csv_gz(os.path.join(sd, f"{k}.csv.gz"), v[:, None])
    return src, dst, feats, labels, split


def process_ogb(ogb_root: str, name: str, out_root: str, with_probs: bool = False, dataset=None):
    """OGB → this layout through a ``NodePropPredDataset``-shaped object
    (``dataset[0] -> (graph_dict, labels)``, ``get_idx_split()``):
    ``dataset`` when given, else the ``ogb`` package's dataset under
    ``ogb_root`` (a pre-downloaded copy).  Products is symmetrized,
    papers100M is not.  Saves under ``out_root/name`` and returns
    ``(arrays, meta)``."""
    if dataset is None:
        try:
            from ogb.nodeproppred import NodePropPredDataset  # optional dependency
        except ImportError as e:
            raise ImportError(
                "process_ogb needs the ogb package, or a NodePropPredDataset-shaped object "
                "passed as dataset=...; a raw OGB download needs neither: process_ogb_raw"
            ) from e
        dataset = NodePropPredDataset(name=name, root=ogb_root)
    graph_raw, labels = dataset[0]
    split = dataset.get_idx_split()
    src, dst = graph_raw["edge_index"]
    n = graph_raw["num_nodes"]
    g = HostGraph.from_coo(src, dst, n, symmetrize=(name == "ogbn-products"))
    arrays = dict(
        indptr=g.indptr,
        indices=g.indices,
        features=graph_raw["node_feat"].astype(np.float32),
        labels=np.nan_to_num(labels.reshape(-1)).astype(np.int32),
        train_idx=split["train"].astype(np.int32),
        valid_idx=split["valid"].astype(np.int32),
        test_idx=split["test"].astype(np.int32),
    )
    if with_probs:
        arrays["probs"] = add_random_probs(g.num_edges)
    meta = dict(
        num_nodes=n,
        num_edges=g.num_edges,
        feature_dim=arrays["features"].shape[1],
        num_classes=int(arrays["labels"].max()) + 1,
        name=name,
    )
    save_dataset(out_root, name, arrays, meta)
    return arrays, meta


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="OGB raw download -> dist_gnn_tpu binary layout")
    ap.add_argument("--ogb-raw", required=True, help="raw OGB dataset dir")
    ap.add_argument("--name", required=True, choices=["ogbn-products", "ogbn-papers100M"])
    ap.add_argument("--out", required=True, help="output root")
    ap.add_argument("--with-probs", action="store_true")
    a = ap.parse_args(argv)
    _, meta = process_ogb_raw(a.ogb_raw, a.name, a.out, with_probs=a.with_probs)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
