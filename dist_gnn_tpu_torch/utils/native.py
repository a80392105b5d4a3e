"""ctypes bridge to the port's host runtime (``csrc/host.cc``).

Counterpart of ``dist_gnn_tpu/utils/native.py``: :func:`gather_rows`
(OpenMP row gather, the staging hot path), :func:`extract_subcsc` (the
compacted adjacency rows of a node set), :func:`build_csc` (the CSC of an
edge list) and :func:`build_alias` (per-row Walker alias tables).  The
library is compiled with g++ into ``_build/`` at first use
(``kernels/build.py``); if it does not build, the call raises.  The numpy
versions (``*_plain``) are the tests' references: no call path falls back
to them.

Every argument is checked here before a pointer reaches C: dtypes,
contiguity, the output's shape and the ids' range where C would read
outside an array.  ctypes releases the GIL for the duration of a call.
``gather_rows.calls`` counts the calls that reached the library.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from dist_gnn_tpu_torch.kernels import build


def _lib() -> ctypes.CDLL:
    lib = build.load("host")
    if not getattr(lib, "_argtypes_set", False):
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dg_gather_rows.argtypes = [i64, p, p, i64, i64, p]
        lib.dg_gather_rows.restype = ctypes.c_int
        lib.dg_extract_subcsc.argtypes = [i64, p, p, p, p, p, p, p]
        lib.dg_extract_subcsc.restype = ctypes.c_int
        lib.dg_build_csc.argtypes = [i64, i64, p, p, p, p, p, p]
        lib.dg_build_csc.restype = ctypes.c_int
        lib.dg_build_alias.argtypes = [i64, p, p, p, p]
        lib.dg_build_alias.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def available() -> bool:
    """Whether the host library is built and loaded in this process."""
    return "host" in build._LOADED


def _ptr(a: Optional[np.ndarray]) -> Optional[int]:
    return None if a is None else a.ctypes.data


def _check_out(base: np.ndarray, n: int, out: Optional[np.ndarray]) -> np.ndarray:
    """The [n, F] output of a gather from ``base``: a fresh zeroed array,
    or ``out`` after its shape and dtype are checked (the C gather copies
    ``base``'s row bytes into every output row, so a narrower ``out`` would
    be written past its end)."""
    if base.ndim != 2:
        raise ValueError(f"gather_rows: base must be 2-D, got shape {base.shape}")
    if out is None:
        return np.zeros((n, base.shape[1]), dtype=base.dtype)
    if out.shape != (n, base.shape[1]) or out.dtype != base.dtype:
        raise ValueError(
            f"gather_rows: out {out.shape}/{out.dtype} must be "
            f"[{n}, {base.shape[1]}] of {base.dtype}"
        )
    return out


def gather_rows_plain(base: np.ndarray, ids: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """numpy version of :func:`gather_rows`: ``out[i] = base[ids[i]]``,
    rows of out-of-range ids left as they are."""
    ids64 = np.asarray(ids, dtype=np.int64)
    out = _check_out(base, len(ids64), out)
    valid = (ids64 >= 0) & (ids64 < base.shape[0])
    out[valid] = base[ids64[valid]]
    return out


def gather_rows(base: np.ndarray, ids: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[i] = base[ids[i]]`` with the OpenMP host gather.

    ``base`` is a C-contiguous 2-D array (numpy or ``np.memmap``); rows of
    out-of-range ids are left as they are in ``out`` (pass a zeroed
    ``out`` and pre-masked ids).  ``out`` defaults to a zeroed [L, F]
    array; a given one must be C-contiguous with exactly that shape and
    ``base``'s dtype, or the call raises."""
    ids64 = np.ascontiguousarray(ids, dtype=np.int64)
    out = _check_out(base, len(ids64), out)
    if not base.flags["C_CONTIGUOUS"] or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("gather_rows: base and out must be C-contiguous")
    rc = _lib().dg_gather_rows(
        len(ids64), _ptr(ids64), _ptr(base), base.shape[0], base.strides[0], _ptr(out)
    )
    if rc != 0:
        raise RuntimeError(f"dg_gather_rows failed with {rc}")
    gather_rows.calls += 1
    return out


gather_rows.calls = 0


def _sub_indptr(cache_nids: np.ndarray, indptr64: np.ndarray) -> np.ndarray:
    deg = indptr64[cache_nids + 1] - indptr64[cache_nids]
    sub_indptr = np.zeros(len(cache_nids) + 1, dtype=np.int64)
    np.cumsum(deg, out=sub_indptr[1:])
    return sub_indptr


def _check_nids(cache_nids, indptr) -> Tuple[np.ndarray, np.ndarray]:
    nids = np.ascontiguousarray(cache_nids, dtype=np.int32)
    indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
    if nids.size and (nids.min() < 0 or nids.max() >= len(indptr64) - 1):
        raise ValueError(f"extract_subcsc: node ids outside [0, {len(indptr64) - 1})")
    return nids, indptr64


def extract_subcsc_plain(
    cache_nids: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    probs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """numpy version of :func:`extract_subcsc`."""
    nids, indptr64 = _check_nids(cache_nids, indptr)
    spans = [np.asarray(indices[indptr64[n] : indptr64[n + 1]]) for n in nids]
    sub_indices = np.concatenate(spans).astype(np.int32) if spans else np.empty(0, np.int32)
    sub_probs = None
    if probs is not None:
        pspans = [np.asarray(probs[indptr64[n] : indptr64[n + 1]]) for n in nids]
        sub_probs = np.concatenate(pspans).astype(np.float32) if pspans else np.empty(0, np.float32)
    return _sub_indptr(nids, indptr64), sub_indices, sub_probs


def extract_subcsc(
    cache_nids: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    probs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Compacted sub-CSR of the given rows: ``(sub_indptr [C+1] int64,
    sub_indices int32[, sub_probs f32])``, row i holding the full neighbour
    list of ``cache_nids[i]`` (JAX: ``native.py:138-190``).  Ids outside
    the graph raise."""
    nids, indptr64 = _check_nids(cache_nids, indptr)
    sub_indptr = _sub_indptr(nids, indptr64)
    indices32 = np.ascontiguousarray(indices, dtype=np.int32)
    probs32 = None if probs is None else np.ascontiguousarray(probs, dtype=np.float32)
    if indptr64[-1] > len(indices32) or (probs32 is not None and probs32.shape != indices32.shape):
        raise ValueError("extract_subcsc: indptr, indices and probs do not form one CSC")
    nnz = int(sub_indptr[-1])
    sub_indices = np.empty(nnz, dtype=np.int32)
    sub_probs = None if probs is None else np.empty(nnz, dtype=np.float32)
    rc = _lib().dg_extract_subcsc(
        len(nids), _ptr(nids), _ptr(indptr64), _ptr(indices32), _ptr(probs32),
        _ptr(sub_indptr), _ptr(sub_indices), _ptr(sub_probs),
    )
    if rc != 0:
        raise RuntimeError(f"dg_extract_subcsc failed with {rc}")
    return sub_indptr, sub_indices, sub_probs


def _csc_dtype(indptr64: np.ndarray, num_edges: int) -> np.ndarray:
    """int32 ``indptr`` below 2**31 edges, int64 above (``graph.py``)."""
    return indptr64.astype(np.int32) if num_edges < 2**31 else indptr64


def _check_coo(dst, src, num_nodes, probs):
    dst32 = np.ascontiguousarray(dst, dtype=np.int32)
    src32 = np.ascontiguousarray(src, dtype=np.int32)
    if dst32.shape != src32.shape or dst32.ndim != 1:
        raise ValueError("build_csc: dst and src must be 1-D and of one length")
    if dst32.size and (dst32.min() < 0 or dst32.max() >= num_nodes):
        raise ValueError(f"from_coo: dst ids outside [0, {num_nodes})")
    probs32 = None if probs is None else np.ascontiguousarray(probs, dtype=np.float32)
    if probs32 is not None and probs32.shape != dst32.shape:
        raise ValueError("build_csc: probs must be parallel to the edges")
    return dst32, src32, probs32


def build_csc_plain(dst, src, num_nodes: int, probs=None):
    """numpy version of :func:`build_csc`: a stable argsort by
    destination."""
    dst32, src32, probs32 = _check_coo(dst, src, num_nodes, probs)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst32, minlength=num_nodes), out=indptr[1:])
    order = np.argsort(dst32, kind="stable")
    indices = src32[order]
    out_probs = None if probs32 is None else probs32[order]
    return _csc_dtype(indptr, len(indices)), indices, out_probs


def build_csc(dst, src, num_nodes: int, probs=None):
    """CSC (row = destination) of a directed edge list: ``(indptr [N+1],
    indices int32[, probs f32])``, each row's edges in edge-list order, with
    ``indptr`` int32 below 2**31 edges (JAX: ``native.py:103-135``).
    Destinations outside ``[0, num_nodes)`` raise."""
    dst32, src32, probs32 = _check_coo(dst, src, num_nodes, probs)
    E = len(dst32)
    if num_nodes == 0:  # no rows, and (checked above) no edges
        return np.zeros(1, np.int32), src32, probs32
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    indices = np.empty(E, dtype=np.int32)
    out_probs = None if probs32 is None else np.empty(E, dtype=np.float32)
    rc = _lib().dg_build_csc(E, num_nodes, _ptr(dst32), _ptr(src32), _ptr(probs32),
                             _ptr(indptr), _ptr(indices), _ptr(out_probs))
    if rc != 0:
        raise RuntimeError(f"dg_build_csc failed with {rc}")
    return _csc_dtype(indptr, E), indices, out_probs


def _check_alias(indptr, weights):
    indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
    w32 = np.ascontiguousarray(weights, dtype=np.float32)
    if indptr64.ndim != 1 or len(indptr64) < 1 or indptr64[0] != 0 or indptr64[-1] != len(w32) \
            or (np.diff(indptr64) < 0).any():
        raise ValueError("build_alias: indptr must run from 0 to len(weights), non-decreasing")
    return indptr64, w32


def build_alias_plain(indptr, weights):
    """numpy version of :func:`build_alias`, row by row in the library's
    arithmetic (a float product ``w * deg``, a double total summed in row
    order), so the tables are equal bit for bit.  The JAX package's own
    numpy fallback computes ``w * deg`` in double and sums pairwise, and
    differs from its native build in the last bits of ``prob``."""
    indptr64, w32 = _check_alias(indptr, weights)
    prob = np.empty(len(w32), dtype=np.float32)
    alias = np.empty(len(w32), dtype=np.int32)
    for r in range(len(indptr64) - 1):
        lo, hi = int(indptr64[r]), int(indptr64[r + 1])
        d = hi - lo
        if d == 0:
            continue
        w = w32[lo:hi]
        total = float(np.cumsum(w.astype(np.float64))[-1])
        if total <= 0:
            prob[lo:hi] = 1.0
            alias[lo:hi] = np.arange(d)
            continue
        scaled = (w * np.float32(d)).astype(np.float64) / total
        small = [i for i in range(d) if scaled[i] < 1.0]
        large = [i for i in range(d) if scaled[i] >= 1.0]
        while small and large:
            s_, l_ = small.pop(), large.pop()
            prob[lo + s_] = scaled[s_]
            alias[lo + s_] = l_
            scaled[l_] = scaled[l_] - (1.0 - scaled[s_])
            (small if scaled[l_] < 1.0 else large).append(l_)
        for i in large + small:  # leftovers
            prob[lo + i] = 1.0
            alias[lo + i] = i
    return prob, alias


def build_alias(indptr, weights):
    """Per-row Walker alias tables of a weighted CSC: ``(prob [E] f32,
    alias [E] int32 offsets within the row)``; a draw takes offset ``j``
    (uniform in the row) if ``u < prob[j]``, else ``alias[j]``.  Equal bit
    for bit to the JAX package's native ``build_alias``
    (``csrc/graph_build.cc:105-172``)."""
    indptr64, w32 = _check_alias(indptr, weights)
    prob = np.empty(len(w32), dtype=np.float32)
    alias = np.empty(len(w32), dtype=np.int32)
    rc = _lib().dg_build_alias(len(indptr64) - 1, _ptr(indptr64), _ptr(w32), _ptr(prob), _ptr(alias))
    if rc != 0:
        raise RuntimeError(f"dg_build_alias failed with {rc}")
    return prob, alias
