"""The port's host runtime (``dist_gnn_tpu_torch/utils/native.py`` over
``csrc/host.cc``, built with g++ at first use) against its numpy versions
and the JAX package's ``utils/native.py``, on the same numpy inputs.

Tolerance: exact everywhere (these are copies of bytes).
"""

import numpy as np
import pytest
import torch

from dist_gnn_tpu.utils import native as jnative
from dist_gnn_tpu_torch.graph import HostGraph
from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.utils import native

torch.set_num_threads(1)


def _csc(seed, n=300, e=2000, weighted=False):
    rng = np.random.default_rng(seed)
    probs = rng.random(e).astype(np.float32) if weighted else None
    hg = HostGraph.from_coo(rng.integers(0, n, e), rng.integers(0, n, e), n, probs=probs)
    return hg, rng


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64])
def test_gather_rows_matches_plain_and_jax(dtype):
    rng = np.random.default_rng(0)
    base = (rng.standard_normal((257, 13)) * 100).astype(dtype)
    ids = rng.integers(-3, 260, 500)  # out-of-range ids leave their rows as they are
    calls = native.gather_rows.calls
    got = native.gather_rows(base, ids)
    assert native.gather_rows.calls == calls + 1 and native.available()
    np.testing.assert_array_equal(got, native.gather_rows_plain(base, ids))
    np.testing.assert_array_equal(got, jnative.gather_rows(base, ids))
    out = np.full((500, 13), 7, dtype)
    native.gather_rows(base, ids, out=out)
    bad = (ids < 0) | (ids >= 257)
    assert (out[bad] == 7).all() and (out[~bad] == base[ids[~bad]]).all()


def test_gather_rows_from_a_memmap_into_a_pinned_view(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((100, 6)).astype(np.float32)
    mm = np.memmap(tmp_path / "f.bin", dtype=np.float32, mode="w+", shape=arr.shape)
    mm[:] = arr
    buf = torch.empty(64, 6)  # the staging path writes into a tensor's numpy view
    ids = rng.integers(0, 100, 40)
    native.gather_rows(mm, ids, out=buf[:40].numpy())
    np.testing.assert_array_equal(buf[:40].numpy(), arr[ids])


@pytest.mark.parametrize(
    "out",
    [np.zeros((5, 3), np.float32), np.zeros((4, 4), np.float32), np.zeros((4, 3), np.float64),
     np.zeros((3, 4), np.float32).T],
    ids=["rows", "width", "dtype", "not_contiguous"],
)
def test_gather_rows_refuses_a_wrong_out(out):
    base = np.ones((10, 3), np.float32)
    with pytest.raises(ValueError):
        native.gather_rows(base, np.arange(4), out=out)


def test_gather_rows_refuses_a_strided_base():
    with pytest.raises(ValueError):
        native.gather_rows(np.ones((10, 6), np.float32)[:, ::2], np.arange(4))


@pytest.mark.parametrize("weighted", [False, True])
def test_extract_subcsc_matches_plain_and_jax(weighted):
    hg, rng = _csc(2, weighted=weighted)
    nids = np.concatenate([rng.choice(300, 120, replace=False), [0, 299, 0]]).astype(np.int32)
    got = native.extract_subcsc(nids, hg.indptr, hg.indices, hg.probs)
    for want in (native.extract_subcsc_plain(nids, hg.indptr, hg.indices, hg.probs),
                 jnative.extract_subcsc(nids, hg.indptr, hg.indices, hg.probs)):
        for a, b in zip(got, want):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    sp, si, _ = got
    assert sp.dtype == np.int64 and si.dtype == np.int32
    for i, n in enumerate(nids):
        np.testing.assert_array_equal(si[sp[i] : sp[i + 1]], hg.indices[hg.indptr[n] : hg.indptr[n + 1]])


def test_extract_subcsc_empty_and_out_of_range():
    hg, _ = _csc(3)
    sp, si, _ = native.extract_subcsc(np.zeros(0, np.int32), hg.indptr, hg.indices)
    assert sp.tolist() == [0] and si.size == 0
    for bad in ([300], [-1]):
        with pytest.raises(ValueError):
            native.extract_subcsc(np.array(bad), hg.indptr, hg.indices)
    with pytest.raises(ValueError):
        native.extract_subcsc(np.array([1]), hg.indptr, hg.indices[:-5])


def test_host_library_is_built_from_the_port_source():
    path = build._lib_path("host")
    assert "host" in build.SOURCES and build._source("host").name == "host.cc"
    native.gather_rows(np.ones((2, 2), np.float32), np.arange(2))
    assert path.exists() and path.parent == build.BUILD_DIR
    assert str(path) == build._LOADED["host"]._name  # never csrc/libdistgnn_host.so
