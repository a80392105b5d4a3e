"""Rowwise uniform neighbour sampling with static padded shapes.

Counterpart of the uniform path of ``dist_gnn_tpu/ops/sampling.py``:

* without replacement, a keyed Feistel permutation of [0, degree) is
  evaluated at slots 0..k-1 (a row of degree <= k takes all of its
  neighbours);
* with replacement, k independent ``bits % degree`` draws.

Padded seeds (INVALID_ID) and zero-degree rows give fully masked rows;
masked slots hold INVALID_ID.  Only the JAX package's exact elementwise
fetch is ported (its window cascade is a TPU gather layout), so no draw
is ever dropped and ``overflow`` is always 0.

Randomness is a pure function of per-row uint32 keys: ``row_key[B]`` for
replace=False, ``bits[B, k]`` for replace=True.  ``key`` is either a
``torch.Generator`` the keys are drawn from, or the key tensor itself, so a
test can inject the JAX package's ``prng.random_keys`` and require the same
samples.

On the card :func:`sample_uniform` is K6, one CUDA kernel per call
(``csrc/sampling.cu`` ``dg_sample_uniform``, whose header notes what it
replaces, what bounds it and how its design meets that bound); its plain
PyTorch version :func:`sample_uniform_plain` serves CPU tensors and only
them.  A CUDA tensor launches the kernel, or raises: there is no fallback.
``sample_uniform.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import torch

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph
from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.ops import prng
from dist_gnn_tpu_torch.kernels.launch import check_launch, require, stream_of

Key = Union[torch.Generator, torch.Tensor]


class SampledNeighbors(NamedTuple):
    ids: torch.Tensor  # [B, k] int32 global neighbour ids, INVALID_ID padded
    mask: torch.Tensor  # [B, k] bool
    # sampled slots masked because a static budget was exceeded: always 0
    # on the exact paths the port has
    overflow: int = 0


def draw_keys(key: Key, shape, device: torch.device) -> torch.Tensor:
    """The uint32 keys of one sampling call: drawn from a generator, or the
    injected tensor itself (checked for shape)."""
    if isinstance(key, torch.Generator):
        return prng.random_keys(key, shape, device)
    key = torch.as_tensor(key)
    if tuple(key.shape) != tuple(shape):
        raise ValueError(f"injected keys have shape {tuple(key.shape)}, need {tuple(shape)}")
    return key.to(device=device, dtype=torch.int64)


def _row_extents(graph: Graph, seeds: torch.Tensor):
    valid = seeds != INVALID_ID
    safe = torch.where(valid, seeds, 0).long()
    start = graph.indptr[safe].long()
    deg = (graph.indptr[safe + 1].long() - start).to(torch.int32)
    deg = torch.where(valid, deg, 0)
    return start, deg, valid


def _lib() -> ctypes.CDLL:
    lib = build.load("sampling")
    if not getattr(lib, "_argtypes_set", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.dg_sample_uniform.argtypes = [p, i32, p, p, p, p, p, i64, i32, i64, i64, i32, p]
        lib.dg_sample_uniform.restype = i32
        lib._argtypes_set = True
    return lib


def plain_positions(graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key):
    """The plain version's selection, op by op: ``(pos, mask)``, the [B, k]
    positions into ``graph.indices`` that the slots read (``start + sel``
    clamped into the edge list) and which slots are taken.  Keys are drawn
    as :func:`sample_uniform` draws them."""
    B = seeds.shape[0]
    dev = seeds.device
    start, deg, valid = _row_extents(graph, seeds)
    j = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k)

    if replace:
        bits = draw_keys(key, (B, k), dev)
        sel = prng.uniform_mod(bits, deg[:, None])
        mask = (valid & (deg > 0))[:, None].expand(B, k)
    else:
        row_key = draw_keys(key, (B,), dev)
        perm = prng.feistel_permutation(j, deg[:, None], row_key[:, None])
        sel = torch.where(deg[:, None] <= k, j, perm)
        mask = valid[:, None] & (j < torch.clamp(deg[:, None], max=k))
    pos = torch.clamp(start[:, None] + sel.long(), 0, max(graph.num_edges - 1, 0))
    return pos, mask


def sample_uniform_plain(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Plain version of K6 (what :func:`sample_uniform` runs for CPU
    tensors), op by op in PyTorch on any device."""
    if graph.num_edges == 0:  # every row is empty, a node-less graph's too
        B = seeds.shape[0]
        draw_keys(key, (B, k) if replace else (B,), seeds.device)  # drawn as on the card
        mask = torch.zeros((B, k), dtype=torch.bool, device=seeds.device)
        ids = torch.full((B, k), INVALID_ID, dtype=torch.int32, device=seeds.device)
        return SampledNeighbors(ids=ids, mask=mask)
    pos, mask = plain_positions(graph, seeds, k, replace, key)
    ids = torch.where(mask, graph.indices[pos], INVALID_ID)
    return SampledNeighbors(ids=ids, mask=mask.contiguous())


def _check_graph(graph: Graph, seeds: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the seeds and the graph suit K6: one CUDA
    device (compared by index: a CPU or meta tensor has index -1), int32
    seeds, an int32 or int64 ``indptr`` and int32 ``indices``, all
    contiguous and 1-D."""
    require(seeds.is_cuda, "seeds must lie on a CUDA device")
    index = seeds.get_device()
    require(
        graph.indptr.get_device() == index and graph.indices.get_device() == index,
        f"the graph must lie on the seeds' CUDA device {index}",
    )
    require(
        seeds.dtype == torch.int32 and seeds.dim() == 1 and seeds.is_contiguous(),
        "seeds must be a contiguous 1-D int32 tensor",
    )
    require(
        graph.indptr.dtype in (torch.int32, torch.int64) and graph.indptr.dim() == 1
        and graph.indptr.is_contiguous() and graph.indptr.shape[0] == graph.num_nodes + 1,
        "indptr must be a contiguous [N + 1] int32 or int64 tensor",
    )
    require(
        graph.indices.dtype == torch.int32 and graph.indices.is_contiguous()
        and graph.indices.shape == (graph.num_edges,),
        "indices must be a contiguous [E] int32 tensor",
    )


def sample_uniform(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Uniformly sample up to ``k`` in-neighbours per seed row — K6 on the
    card, one launch per call (plain version: :func:`sample_uniform_plain`).
    The keys are drawn (or checked) as the plain version draws them; an
    edgeless graph or an empty output is answered without a launch.  Ids
    and mask equal the plain version's bit for bit.

    Distinctness caveat (replace=False): picks come from a keyed Feistel
    permutation whose cycle-walk fallback breaks bijectivity with ~1e-3
    probability per element (``prng.feistel_permutation``), so a row can
    very rarely hold a duplicate neighbour.  The relabel dedups, so results
    stay correct; only the sampling statistics carry the ~0.1% noise.
    """
    if seeds.device.type == "cpu":
        return sample_uniform_plain(graph, seeds, k, replace, key)
    _check_graph(graph, seeds)
    B = seeds.shape[0]
    keys = draw_keys(key, (B, k) if replace else (B,), seeds.device).contiguous()
    if graph.num_edges == 0 or B * k == 0:
        return SampledNeighbors(
            ids=torch.full((B, k), INVALID_ID, dtype=torch.int32, device=seeds.device),
            mask=torch.zeros((B, k), dtype=torch.bool, device=seeds.device),
        )
    ids = torch.empty((B, k), dtype=torch.int32, device=seeds.device)
    mask = torch.empty((B, k), dtype=torch.bool, device=seeds.device)
    rc = _lib().dg_sample_uniform(
        graph.indptr.data_ptr(), int(graph.indptr.dtype == torch.int64), graph.indices.data_ptr(),
        seeds.data_ptr(), keys.data_ptr(), ids.data_ptr(), mask.data_ptr(),
        B, k, graph.num_nodes, graph.num_edges, int(replace), stream_of(seeds),
    )
    check_launch(rc, "sample_uniform")
    sample_uniform.launches += 1
    return SampledNeighbors(ids=ids, mask=mask)


sample_uniform.launches = 0


def sample_neighbors(
    graph: Graph, seeds: torch.Tensor, k: int, replace: bool, key: Key
) -> SampledNeighbors:
    """Dispatch on ``graph.probs`` like the JAX package.  Only uniform
    sampling is ported; a weighted graph raises."""
    if graph.probs is not None:
        raise NotImplementedError(
            "biased (weighted) sampling is not ported yet; drop graph.probs "
            "for uniform sampling"
        )
    return sample_uniform(graph, seeds, k, replace, key)
