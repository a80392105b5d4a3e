"""The benchmark's inputs, made on the device from ``--seed``.

The graph follows the power-law community law of the program's synthetic
generator (``dataloading/preprocess.make_synthetic_dataset``), rewritten
here in torch so that it runs on the card in a few large calls:

* labels uniform over the classes;
* both endpoints of every undirected edge drawn from a power law of
  power ``degree_power`` over the ranks of a random permutation of the
  nodes, with its head flattened by an offset ``r0``: rank ``r`` (from 0)
  has weight ``(r + r0) ** -p`` (inverse CDF
  ``x = ((N + r0)**(1-p) u + r0**(1-p) (1-u))**(1/(1-p))``, rank
  ``floor(x - r0)``).  ``r0`` is solved so that the top rank's expected
  degree is the configuration's ``max_degree`` (ogbn-products' largest);
  without it the top node of 2.45M would take about 670k edges;
* a share ``intra_class_share`` of the edges moves its source to a node of
  the destination's class, drawn uniformly;
* the edge list is symmetrised and sorted stably by destination into a CSC
  (row = destination, the row holds the in-neighbours);
* features are the class centroid plus ``1.5 * N(0, 1)`` noise, stored in
  the configuration's feature dtype; the training nodes are the first
  ``num_train_nodes`` of a random permutation.

The same seed gives the same tensors on the same kind of device.  The
drivers make the configuration's one graph (its ``graph_seed``): a run's
``--seed`` draws the weights and the traffic, not the dataset.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named use of the run's seed, so
    that the inputs, the weights and the traffic draw from streams of their
    own."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63))
    return g


def top_share(n: int, power: float, r0: float) -> float:
    """The top rank's share of the draws under offset ``r0``."""
    a = 1.0 - power
    return ((r0 + 1) ** a - r0**a) / ((n + r0) ** a - r0**a)


def head_offset(n: int, e: int, power: float, intra: float, max_degree: float) -> float:
    """The offset ``r0`` (at least 1) at which the top node's expected
    degree is ``max_degree``.  A node of draw share ``s`` is the destination
    of ``e s`` edges, the source of ``(1 - intra) e s`` more, and takes
    about ``intra e / n`` moved sources of its class."""
    want = (max_degree - intra * e / n) / ((2.0 - intra) * e)
    lo, hi = 1.0, float(n)
    if top_share(n, power, lo) <= want:
        return lo
    for _ in range(200):  # the share falls as r0 grows
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if top_share(n, power, mid) > want else (lo, mid)
    return hi


def make_graph(cfg: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``{indptr [N+1] int32, indices [2E] int32, features [N, F], labels [N]
    int32, train_idx [T] int32}`` on ``device``, with the sizes of ``cfg``'s
    ``graph`` group."""
    gcfg = cfg["graph"]
    n = int(gcfg["num_nodes"])
    e = int(gcfg["num_undirected_edges"])
    f = int(gcfg["feature_dim"])
    c = int(gcfg["num_classes"])
    power = float(cfg["assumed"]["degree_power"])
    intra = float(cfg["assumed"]["intra_class_share"])
    r0 = head_offset(n, e, power, intra, float(cfg["assumed"]["max_degree"]))
    a = 1.0 - power
    g = generator(seed, device, 0)

    labels = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    perm = torch.randperm(n, generator=g, device=device)

    def zipf_nodes(count: int) -> torch.Tensor:
        u = torch.rand(count, generator=g, device=device, dtype=torch.float64)
        x = ((n + r0) ** a * u + r0**a * (1 - u)) ** (1 / a)
        return perm[(x - r0).long().clamp_(0, n - 1)].to(torch.int32)

    dst = zipf_nodes(e)
    src = zipf_nodes(e)
    # a share of the edges keeps its source inside the destination's class
    same = torch.rand(e, generator=g, device=device) < intra
    by_label = torch.argsort(labels, stable=True).to(torch.int32)
    counts = torch.bincount(labels, minlength=c)
    starts = torch.cumsum(counts, 0) - counts
    lab = labels[dst.long()].long()
    pick = (torch.rand(e, generator=g, device=device, dtype=torch.float64) * counts[lab]).long()
    pick = torch.minimum(pick, (counts[lab] - 1).clamp(min=0))
    moved = by_label[(starts[lab] + pick).clamp_(0, n - 1)]
    src = torch.where(same & (counts[lab] > 0), moved, src)
    del same, lab, pick, moved

    rows = torch.cat([dst, src])
    cols = torch.cat([src, dst])
    del dst, src
    order = torch.sort(rows, stable=True).indices
    indices = cols[order]
    deg = torch.bincount(rows, minlength=n)
    del rows, cols, order
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=indptr[1:])

    centroids = torch.randn((c, f), generator=g, device=device)
    noise = torch.randn((n, f), generator=g, device=device)
    features = (centroids[labels.long()] + 1.5 * noise).to(DTYPES[gcfg["feature_dtype"]])
    del noise
    train_idx = torch.randperm(n, generator=g, device=device)[: int(gcfg["num_train_nodes"])]
    return {
        "indptr": indptr.to(torch.int32),
        "indices": indices,
        "features": features,
        "labels": labels,
        "train_idx": train_idx.to(torch.int32),
    }
