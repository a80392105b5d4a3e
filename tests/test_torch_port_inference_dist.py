"""The ring full-graph inference against the JAX package's, world 2.

``build_ring_layout`` pads the per-owner edge buckets that the ring walks
and must equal JAX's array for array; the buckets each rank builds inside
the world must equal the unpadded prefix of JAX's ``[rank, o]`` buckets.
``dist_full_graph_inference`` runs for SAGE, GCN and GAT
in one spawned world of two gloo ranks (the blocks travel by
``batch_isend_irecv``) and is held, in f32, to JAX's ring inference on
``make_mesh(2)`` (rtol 1e-4 / atol 1e-5: summation order, JAX summing in
the activations' dtype per rotation, the port in f32) and to the port's
own single-device ``full_graph_inference`` (1e-5).  The node count is odd,
so the last shard carries padding rows.
"""

import traceback

import jax
import numpy as np
import pytest
import torch

from dist_gnn_tpu.graph import HostGraph as JHostGraph
from dist_gnn_tpu.models.gat import GAT as JGAT
from dist_gnn_tpu.models.gcn import GCN as JGCN
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.parallel import inference_dist as jid
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu_torch.graph import HostGraph as THostGraph
from dist_gnn_tpu_torch.models import GAT as TGAT
from dist_gnn_tpu_torch.models import GCN as TGCN
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.models.inference import full_graph_inference
from dist_gnn_tpu_torch.parallel import inference_dist as tid
from dist_gnn_tpu_torch.parallel import mesh as tmesh
from dist_gnn_tpu_torch.weights import gat_params_from_jax, gcn_params_from_jax, sage_params_from_jax

torch.set_num_threads(1)
WORLD = 2


def _graph(N=701, E=9000, F=9, seed=5):
    rng = np.random.default_rng(seed)
    dst = np.concatenate([rng.integers(0, N - 15, E), np.full(200, 3)])  # a hub; the last rows empty
    src = rng.integers(0, N, dst.shape[0])
    hg = JHostGraph.from_coo(src.astype(np.int32), dst.astype(np.int32), N)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    return np.asarray(hg.indptr), np.asarray(hg.indices), feats


@pytest.mark.parametrize("D,edge_chunk", [(1, 64), (2, 64), (3, 100), (8, 32)])
def test_build_ring_layout_matches_jax(D, edge_chunk):
    ip, ix, _ = _graph()
    got = tid.build_ring_layout(THostGraph(indptr=ip, indices=ix), D, edge_chunk)
    want = jid.build_ring_layout(JHostGraph(indptr=ip, indices=ix), D, edge_chunk)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _models(kind):
    if kind == "sage":
        return JSAGE(9, 6, 4, 2, dropout=0.0), TSAGE(9, 6, 4, 2, device="cpu"), sage_params_from_jax
    if kind == "gcn":
        return JGCN(9, 6, 4, 2, dropout=0.0), TGCN(9, 6, 4, 2, device="cpu"), gcn_params_from_jax
    return (JGAT(9, 5, 4, 2, num_heads=2, dropout=0.0, use_fused=False), TGAT(9, 5, 4, 2, num_heads=2, device="cpu"),
            gat_params_from_jax)


def _port_model(kind, params_np):
    _, tm, conv = _models(kind)
    tm.load_state_dict(conv(params_np))
    return tm


def _case_infer(mesh, kind, params_np, g, edge_chunk, as_state_dict):
    ip, ix, feats = g
    tm = _port_model(kind, params_np)
    params = {k: v.clone() for k, v in tm.state_dict().items()} if as_state_dict else None
    counts = dict(mesh.counts)
    out = tid.dist_full_graph_inference(tm, params, THostGraph(indptr=ip, indices=ix), feats, mesh, edge_chunk)
    return out.numpy(), {k: mesh.counts[k] - counts[k] for k in counts}


def _case_buckets(mesh, g):
    ip, ix, _ = g
    S = (len(ip) - 1 + mesh.size - 1) // mesh.size
    buckets = tid._ring_buckets(THostGraph(indptr=ip, indices=ix), mesh.size, mesh.rank, S, mesh.device)
    return [(src.numpy(), dst.numpy()) for src, dst in buckets]


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


KINDS = ("sage", "gcn", "gat")


@pytest.fixture(scope="module")
def setup():
    g = _graph()
    params = {k: _models(k)[0].init(jax.random.key(i)) for i, k in enumerate(KINDS)}
    params_np = {k: jax.tree.map(np.asarray, v) for k, v in params.items()}
    cases = {k: (_case_infer, (k, params_np[k], g, 128, k == "gcn")) for k in KINDS}
    cases["buckets"] = (_case_buckets, (g,))
    port = tmesh.launch(_run_cases, WORLD, args=(cases,), device="cpu", timeout_s=240)
    return g, params, params_np, port


def test_ring_buckets_built_in_the_world_match_jax(setup):
    (ip, ix, _), _, _, port = setup
    _, _, src_local, dst_rows, valid, _ = jid.build_ring_layout(JHostGraph(indptr=ip, indices=ix), WORLD, 64)
    for r in range(WORLD):
        status, buckets = port[r]["buckets"]
        if status != "ok":
            pytest.fail(f"rank {r} failed:\n{buckets}")
        assert len(buckets) == WORLD
        for o, (src, dst) in enumerate(buckets):
            c = int(valid[r, o].sum())
            assert valid[r, o, :c].all() and src.shape == dst.shape == (c,)
            np.testing.assert_array_equal(src, src_local[r, o, :c])
            np.testing.assert_array_equal(dst, dst_rows[r, o, :c])


@pytest.mark.parametrize("kind", KINDS)
def test_dist_full_graph_inference_matches_jax_and_single_device(setup, kind):
    (ip, ix, feats), params, params_np, port = setup
    jm = _models(kind)[0]
    want_jax = jid.dist_full_graph_inference(jm, params[kind], JHostGraph(indptr=ip, indices=ix), feats,
                                            jmake_mesh(WORLD), edge_chunk=128)
    want_port = full_graph_inference(_port_model(kind, params_np[kind]), None, THostGraph(indptr=ip, indices=ix),
                                     torch.from_numpy(feats), edge_chunk=256, device="cpu").numpy()
    for r in range(WORLD):
        status, payload = port[r][kind]
        if status != "ok":
            pytest.fail(f"rank {r} failed:\n{payload}")
        got, counts = payload
        assert got.shape == (len(ip) - 1, 4) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, want_port, rtol=1e-5, atol=1e-5)
        # one block pass per layer (two for GAT: z and er), one all-gather
        assert counts["p2p"] == 2 * (2 if kind == "gat" else 1)
        assert counts["all_gather"] == 1 and counts["all_to_all"] == counts["host_syncs"] == 0
