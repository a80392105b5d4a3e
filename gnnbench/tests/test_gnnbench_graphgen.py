"""The generator: the same tensors from the same seed, a valid symmetric
CSC, and the stated sizes."""

import pytest
import torch

from gnnbench.graphgen import make_graph
from gnnbench.tests.small import config

CPU = torch.device("cpu")


def test_deterministic_from_the_seed():
    cfg = config("sage-products")
    a, b, c = (make_graph(cfg, s, CPU) for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["indices"], c["indices"])


def test_valid_symmetric_csc_of_the_stated_sizes():
    cfg = config("sage-products", nodes=2000, edges=15000, train=300)
    g = make_graph(cfg, 11, CPU)
    n, e = 2000, 15000
    indptr, indices = g["indptr"].long(), g["indices"].long()
    assert indptr.shape == (n + 1,) and indptr[0] == 0 and indptr[-1] == 2 * e
    assert bool((indptr[1:] >= indptr[:-1]).all())
    assert indices.shape == (2 * e,) and int(indices.min()) >= 0 and int(indices.max()) < n
    rows = torch.repeat_interleave(torch.arange(n), indptr[1:] - indptr[:-1])
    fwd = torch.sort(rows * n + indices).values
    bwd = torch.sort(indices * n + rows).values
    assert torch.equal(fwd, bwd)  # every edge's reverse is in the graph
    assert g["features"].shape == (n, 100) and g["features"].dtype == torch.bfloat16
    assert g["labels"].shape == (n,) and int(g["labels"].max()) < 47
    tr = g["train_idx"]
    assert tr.shape == (300,) and torch.unique(tr).numel() == 300


def test_degree_law_is_skewed():
    g = make_graph(config("sage-products", nodes=5000, edges=50000), 3, CPU)
    deg = (g["indptr"][1:] - g["indptr"][:-1]).float()
    assert float(deg.max()) > 20 * float(deg.mean())


def test_the_head_is_held_to_the_largest_degree():
    """The head's offset brings the top node's expected degree to the
    configuration's ``max_degree``, and the mean stays the stated one."""
    from gnnbench.graphgen import head_offset, top_share

    n, e = 2449029, 61859140
    r0 = head_offset(n, e, 0.8, 0.7, 17481)
    assert top_share(n, 0.8, r0) * e * 1.3 + 0.7 * e / n == pytest.approx(17481, rel=1e-6)
    assert top_share(n, 0.8, 1.0) * e * 1.3 > 600000  # unflattened, the top node would take ~666k
    cfg = config("sage-products", nodes=20000, edges=300000)
    cfg["assumed"]["max_degree"] = 400
    g = make_graph(cfg, 7, CPU)
    deg = (g["indptr"][1:] - g["indptr"][:-1]).float()
    assert float(deg.mean()) == pytest.approx(30.0)
    assert 0.8 * 400 < float(deg.max()) < 1.25 * 400
    assert float(deg.max()) > 8 * float(deg.mean())  # still skewed below the head
