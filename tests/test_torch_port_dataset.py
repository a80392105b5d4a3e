"""The port's dataset I/O (``dataloading/preprocess.py``) and the last
getters (``Graph.has_probs``, ``degrees_of``, ``edge_rows``,
``NeighborSampler.structure_tensors``) against the JAX package's, on the
CPU at tiny sizes.

Tolerances: exact everywhere.  Integers, labels, splits, probs and the
CSC arrays are compared bit for bit, dtypes included.  The features of
``process_ogb_raw`` are exact too: the fixture writes float32 values with
``str``, which round-trips in float32, and JAX's pandas parse and the
port's numpy parse land on float64 values that round to the same float32.
"""

import gzip
import importlib.util
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.dataloading import preprocess as tpre
from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
OGB_NAMES = ("ogbn-products", "ogbn-papers100M")


def _assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_same(got[k], want[k], k)


# ---- save / load ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return tpre.make_synthetic_dataset(num_nodes=400, avg_degree=5, feature_dim=8, num_classes=4,
                                       with_probs=True, seed=1)


def test_synthetic_dataset_equals_jax_s():
    got = tpre.make_synthetic_dataset(num_nodes=300, avg_degree=4, feature_dim=6, num_classes=3,
                                      with_probs=True, seed=5)
    want = jpre.make_synthetic_dataset(num_nodes=300, avg_degree=4, feature_dim=6, num_classes=3,
                                       with_probs=True, seed=5)
    _assert_same_arrays(got[0], {k: np.asarray(v) for k, v in want[0].items()})
    assert got[1] == want[1]


@pytest.mark.parametrize("mmap", [True, False])
@pytest.mark.parametrize("writer,reader", [(tpre, jpre), (jpre, tpre), (tpre, tpre)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_save_with_one_package_load_with_the_other(tmp_path, tiny, writer, reader, mmap):
    arrays, meta = tiny
    writer.save_dataset(str(tmp_path), "tiny", arrays, meta)
    assert sorted(os.listdir(tmp_path / "tiny")) == sorted([f"{k}.npy" for k in arrays] + ["metadata.json"])
    loaded, meta2 = reader.load_dataset(str(tmp_path), "tiny", mmap=mmap)
    assert meta2 == meta
    _assert_same_arrays({k: np.asarray(v) for k, v in loaded.items()}, arrays)
    for v in loaded.values():
        assert isinstance(v, np.memmap) == mmap
        assert v.flags.writeable != mmap  # memmaps are read-only


def test_load_dataset_skips_absent_optional_arrays(tmp_path, tiny):
    arrays, meta = tiny
    jpre.save_dataset(str(tmp_path), "noprobs", {k: v for k, v in arrays.items() if k != "probs"}, meta)
    loaded, _ = tpre.load_dataset(str(tmp_path), "noprobs")
    assert "probs" not in loaded and len(loaded) == 7


def test_a_memmapped_graph_uploads_as_the_in_memory_one(tmp_path, tiny):
    """The read-only memmaps of a loaded dataset reach torch by a copy (no
    warning), and give the graph the in-memory arrays give."""
    arrays, meta = tiny
    tpre.save_dataset(str(tmp_path), "tiny", arrays, meta)
    loaded, _ = tpre.load_dataset(str(tmp_path), "tiny", mmap=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g_m = HostGraph(indptr=loaded["indptr"], indices=loaded["indices"], probs=loaded["probs"]).to_device(
            "cpu", with_alias=True)
    g = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"], probs=arrays["probs"]).to_device(
        "cpu", with_alias=True)
    assert g_m.indptr.dtype == torch.int32 and g_m.max_degree == g.max_degree
    for name in ("indptr", "indices", "probs", "alias_prob", "alias_idx"):
        assert torch.equal(getattr(g_m, name), getattr(g, name)), name


# ---- replicate_graph ----------------------------------------------------------------

@pytest.mark.parametrize("copies", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 7])
def test_replicate_graph_is_jax_s(tiny, copies, seed):
    arrays, _ = tiny
    got = tpre.replicate_graph(arrays["indptr"], arrays["indices"], copies, seed=seed)
    want = jpre.replicate_graph(arrays["indptr"], arrays["indices"], copies, seed=seed)
    _assert_same(got[0], want[0], "indptr")
    _assert_same(got[1], want[1], "indices")
    assert len(got[0]) == copies * 400 + 1


# ---- raw OGB ingestion -------------------------------------------------------------

def _files(root: Path) -> dict:
    """Every file under ``root`` by relative path: ``.csv.gz`` decompressed,
    ``.npz`` as its arrays."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(root).as_posix()
        if rel.endswith(".npz"):
            with np.load(p) as z:
                out[rel] = {k: z[k] for k in z.files}
        else:
            out[rel] = gzip.decompress(p.read_bytes())
    return out


@pytest.mark.parametrize("name", OGB_NAMES)
def test_make_ogb_raw_fixture_writes_jax_s_files(tmp_path, name):
    got = tpre.make_ogb_raw_fixture(str(tmp_path / "port"), name, seed=3)
    want = jpre.make_ogb_raw_fixture(str(tmp_path / "jax"), name, seed=3)
    for g, w in zip(got[:4], want[:4]):
        _assert_same(g, w)
    assert sorted(got[4]) == sorted(want[4])
    for k in want[4]:
        _assert_same(got[4][k], want[4][k], k)
    fp, fj = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(fp) == sorted(fj) and len(fp) == (6 if name == "ogbn-products" else 5)
    for rel, content in fj.items():
        if isinstance(content, dict):
            assert sorted(fp[rel]) == sorted(content)
            for k in content:
                _assert_same(fp[rel][k], content[k], f"{rel}:{k}")
        else:
            assert fp[rel] == content, rel


@pytest.mark.parametrize("with_probs", [False, True])
@pytest.mark.parametrize("name", OGB_NAMES)
def test_process_ogb_raw_is_jax_s(tmp_path, name, with_probs):
    raw = tmp_path / "raw_download"
    jpre.make_ogb_raw_fixture(str(raw), name, seed=4, n=60)
    got, meta = tpre.process_ogb_raw(str(raw), name, str(tmp_path / "port"), with_probs=with_probs)
    want, meta_j = jpre.process_ogb_raw(str(raw), name, str(tmp_path / "jax"), with_probs=with_probs)
    assert meta == meta_j
    assert meta["num_nodes"] == 60 and meta["feature_dim"] == 8
    assert meta["num_edges"] == (2 if name == "ogbn-products" else 1) * 240  # products is symmetrized
    _assert_same_arrays(got, {k: np.asarray(v) for k, v in want.items()})
    assert got["features"].dtype == np.float32 and got["labels"].dtype == np.int32
    # the saved directories hold the same files
    loaded_p, mp = tpre.load_dataset(str(tmp_path / "port"), name, mmap=False)
    loaded_j, mj = jpre.load_dataset(str(tmp_path / "jax"), name, mmap=False)
    assert mp == mj
    _assert_same_arrays(loaded_p, loaded_j)


def test_process_ogb_raw_papers_labels_nan_to_zero(tmp_path):
    raw = tmp_path / "raw_download"
    _, _, _, labels, split = tpre.make_ogb_raw_fixture(str(raw), "ogbn-papers100M", seed=1)
    arrays, meta = tpre.process_ogb_raw(str(raw), "ogbn-papers100M", str(tmp_path / "out"))
    assert np.isnan(labels[split["test"]]).all()
    assert (arrays["labels"][split["test"]] == 0).all()
    assert meta["num_classes"] == int(np.nan_to_num(labels).max()) + 1


def test_process_ogb_raw_refuses_an_unknown_name(tmp_path):
    with pytest.raises(ValueError, match="unknown raw OGB dataset"):
        tpre.process_ogb_raw(str(tmp_path), "ogbn-arxiv", str(tmp_path / "out"))


def _jax_stub():
    spec = importlib.util.spec_from_file_location("jax_test_dataset", ROOT / "tests" / "test_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._StubOGB


@pytest.mark.parametrize("with_probs", [False, True])
@pytest.mark.parametrize("name", OGB_NAMES)
def test_process_ogb_with_jax_s_stub(tmp_path, name, with_probs):
    stub = _jax_stub()()
    got, meta = tpre.process_ogb("/nonexistent", name, str(tmp_path / "port"), with_probs=with_probs,
                                 dataset=stub)
    want, meta_j = jpre.process_ogb("/nonexistent", name, str(tmp_path / "jax"), with_probs=with_probs,
                                    dataset=stub)
    assert meta == meta_j
    _assert_same_arrays(got, {k: np.asarray(v) for k, v in want.items()})


def test_process_ogb_without_a_dataset_names_the_option(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ogb", None)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", None)
    with pytest.raises(ImportError, match="dataset="):
        tpre.process_ogb(str(tmp_path), "ogbn-products", str(tmp_path / "out"))


def test_the_cli_ingests_a_raw_download(tmp_path):
    raw = tmp_path / "raw_download"
    jpre.make_ogb_raw_fixture(str(raw), "ogbn-products", seed=2)
    out = subprocess.run(
        [sys.executable, "-m", "dist_gnn_tpu_torch.dataloading.preprocess", "--ogb-raw", str(raw),
         "--name", "ogbn-products", "--out", str(tmp_path / "port"), "--with-probs"],
        capture_output=True, text=True, cwd=ROOT, timeout=120, check=True,
    ).stdout
    want, meta_j = jpre.process_ogb_raw(str(raw), "ogbn-products", str(tmp_path / "jax"), with_probs=True)
    assert json.loads(out.strip().splitlines()[-1]) == meta_j
    loaded, _ = tpre.load_dataset(str(tmp_path / "port"), "ogbn-products", mmap=False)
    _assert_same_arrays(loaded, {k: np.asarray(v) for k, v in want.items()})


# ---- the getters --------------------------------------------------------------------

def _getter_graph(indptr_dtype, weighted):
    """Rows 0 and 3 empty, row 5 the last with edges, rows 6-7 empty."""
    deg = np.array([0, 3, 1, 0, 4, 2, 0, 0])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(indptr_dtype)
    rng = np.random.default_rng(0)
    indices = rng.integers(0, len(deg), int(deg.sum())).astype(np.int32)
    probs = rng.random(int(deg.sum())).astype(np.float32) if weighted else None
    return indptr, indices, probs


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
def test_getters_are_jax_s(indptr_dtype, weighted):
    indptr, indices, probs = _getter_graph(indptr_dtype, weighted)
    tg = HostGraph(indptr=indptr, indices=indices, probs=probs).to_device("cpu")
    jg = jgraph.HostGraph(indptr=indptr, indices=indices, probs=probs).to_device()
    assert tg.indptr.dtype == torch.from_numpy(indptr).dtype
    assert tg.has_probs == jg.has_probs == weighted
    nids = np.array([0, 1, 2, 3, 4, 5, 6, 7, INVALID_ID, 4, INVALID_ID, 0], np.int32)
    got = tg.degrees_of(torch.from_numpy(nids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.degrees_of(nids)))
    assert got[nids == INVALID_ID].eq(0).all()
    rows = tg.edge_rows()
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jg.edge_rows()))
    np.testing.assert_array_equal(rows.numpy(), np.repeat(np.arange(8), np.diff(indptr)))

    t_ptr, t_idx, t_pr = tsampler.NeighborSampler(tg, (3, 2)).structure_tensors()
    j_ptr, j_idx, j_pr = jsampler.NeighborSampler(jg, (3, 2)).structure_tensors()
    np.testing.assert_array_equal(t_ptr.numpy(), np.asarray(j_ptr))
    # JAX pads its device edge arrays past nnz; the first nnz entries are the graph
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx)[: len(indices)])
    assert (t_pr is None) == (j_pr is None) == (not weighted)
    if weighted:
        np.testing.assert_array_equal(t_pr.numpy(), np.asarray(j_pr)[: len(indices)])
