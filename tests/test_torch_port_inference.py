"""Full-graph inference of GAT and GCN, and the host-resident walk of all
three families: the port against the JAX package on the same graph,
features and weights, in f32.

Tolerances: rtol = atol = 1e-5 for SAGE and GCN (summation order only);
1e-4 for GAT, whose softmax the port shifts by the row maximum where the
JAX walk carries a running logsumexp, so the exponentials round apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models import GAT as JGAT
from dist_gnn_tpu.models import GCN as JGCN
from dist_gnn_tpu.models import SAGE as JSAGE
from dist_gnn_tpu.models import inference as jinf
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch.models import GAT as TGAT
from dist_gnn_tpu_torch.models import GCN as TGCN
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.models import inference as tinf
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.weights import (
    gat_params_from_jax,
    gcn_params_from_jax,
    sage_params_from_jax,
)

torch.set_num_threads(1)
TOL = {"sage": 1e-5, "gcn": 1e-5, "gat": 1e-4}


def _pair(kind, in_feats, hidden, classes, layers, seed=0):
    """The JAX model and params and the port's model with the same
    weights (dropout off, f32)."""
    if kind == "sage":
        jm, tm, conv = JSAGE(in_feats, hidden, classes, layers, dropout=0.0), TSAGE, sage_params_from_jax
        tm = tm(in_feats, hidden, classes, layers, dropout=0.0, device="cpu")
    elif kind == "gcn":
        jm, conv = JGCN(in_feats, hidden, classes, layers, dropout=0.0), gcn_params_from_jax
        tm = TGCN(in_feats, hidden, classes, layers, dropout=0.0, device="cpu")
    else:
        jm, conv = JGAT(in_feats, hidden, classes, layers, num_heads=2, dropout=0.0), gat_params_from_jax
        tm = TGAT(in_feats, hidden, classes, layers, num_heads=2, dropout=0.0, device="cpu")
    jp = jm.init(jax.random.key(seed))
    tm.load_state_dict(conv(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(scope="module")
def data():
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=400, avg_degree=5, feature_dim=12, num_classes=6, train_frac=0.3, seed=1
    )
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    thg = tgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    return arrays, meta, jhg, thg


@pytest.mark.parametrize("edge_chunk", [7, 1 << 18])
@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_full_graph_inference_matches_jax(data, kind, edge_chunk):
    """A 7-edge chunk splits most rows across chunks (max degree > 7)."""
    arrays, meta, jhg, thg = data
    assert int(np.diff(arrays["indptr"]).max()) > 7
    jm, jp, tm = _pair(kind, 12, 8, meta["num_classes"], 3, seed=2)
    feats = arrays["features"]
    ref = jinf.full_graph_inference(jm, jp, jhg, jnp.asarray(feats))
    out = tinf.full_graph_inference(tm, None, thg, torch.from_numpy(feats), edge_chunk=edge_chunk, device="cpu")
    assert out.shape == (meta["num_nodes"], meta["num_classes"]) and out.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=TOL[kind], atol=TOL[kind])
    # weights passed as a state_dict give the same output
    _, _, fresh = _pair(kind, 12, 8, meta["num_classes"], 3, seed=7)
    out2 = tinf.full_graph_inference(
        fresh, tm.state_dict(), thg, torch.from_numpy(feats), edge_chunk=edge_chunk, device="cpu"
    )
    assert torch.equal(out, out2)
    assert tgather.gather_rows.launches == 0


def _isolated_graph():
    """10 nodes, edges into nodes 0..4 only; nodes 5..9 have no in-edge
    (tests/test_inference_host.py's graph)."""
    src = np.array([1, 2, 3, 4, 0, 1, 2, 3], np.int64)
    dst = np.array([0, 0, 1, 1, 2, 2, 3, 4], np.int64)
    feats = np.random.default_rng(3).standard_normal((10, 5)).astype(np.float32)
    return (jgraph.HostGraph.from_coo(src, dst, 10), tgraph.HostGraph.from_coo(src, dst, 10), feats)


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
def test_full_graph_inference_isolated_nodes(kind):
    jhg, thg, feats = _isolated_graph()
    jm, jp, tm = _pair(kind, 5, 4, 3, 2, seed=4)
    ref = jinf.full_graph_inference(jm, jp, jhg, jnp.asarray(feats), node_chunk=4, edge_chunk=4)
    out = tinf.full_graph_inference(tm, None, thg, torch.from_numpy(feats), edge_chunk=3, device="cpu")
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=TOL[kind], atol=TOL[kind])
    if kind == "gat":
        # rows with no in-edge aggregate to 0: the last layer's output is
        # the heads' mean bias, here 0
        assert (out[5:] == 0).all()


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
def test_full_graph_inference_host_matches_jax(kind, tmp_path):
    """A memmap of features, chunks far smaller than the graph (many slabs,
    an uneven last node chunk: 500 = 3 x 128 + 116), against JAX's own
    host-resident walk and its device-resident one."""
    rng = np.random.default_rng(9)
    N, E, F = 500, 6000, 8
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    jhg, thg = jgraph.HostGraph.from_coo(src, dst, N), tgraph.HostGraph.from_coo(src, dst, N)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    mm = np.memmap(tmp_path / "feats.bin", dtype=np.float32, mode="w+", shape=(N, F))
    mm[:] = feats
    jm, jp, tm = _pair(kind, F, 6, 4, 2, seed=1)
    ref_host = jinf.full_graph_inference_host(jm, jp, jhg, feats, node_chunk=128, edge_chunk=192)
    out = tinf.full_graph_inference_host(tm, None, thg, mm, node_chunk=128, edge_chunk=192, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == (N, 4) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_host, rtol=2 * TOL[kind], atol=2 * TOL[kind])
    ref_dev = tinf.full_graph_inference(tm, None, thg, torch.from_numpy(feats), device="cpu")
    np.testing.assert_allclose(out, ref_dev.numpy(), rtol=2 * TOL[kind], atol=2 * TOL[kind])


def test_full_graph_inference_host_isolated_nodes():
    jhg, thg, feats = _isolated_graph()
    for kind in ("sage", "gcn", "gat"):
        jm, jp, tm = _pair(kind, 5, 4, 3, 2, seed=2)
        ref = jinf.full_graph_inference_host(jm, jp, jhg, feats, node_chunk=4, edge_chunk=4)
        out = tinf.full_graph_inference_host(tm, None, thg, feats, node_chunk=4, edge_chunk=4, device="cpu")
        np.testing.assert_allclose(out, ref, rtol=2 * TOL[kind], atol=2 * TOL[kind], err_msg=kind)


def test_host_inference_rejects_other_models_and_needs_a_card(data, monkeypatch):
    arrays, _, _, thg = data
    with pytest.raises(NotImplementedError):
        tinf.full_graph_inference_host(torch.nn.Linear(2, 2), None, thg, arrays["features"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = TGCN(12, 8, 6, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.full_graph_inference_host(tm, None, thg, arrays["features"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.full_graph_inference(tm, None, thg, torch.from_numpy(arrays["features"]))
