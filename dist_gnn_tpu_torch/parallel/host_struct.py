"""Host-resident graph structure over the ranks: each rank's hot sub-CSC
on its device, the whole CSC in host memory.

Counterpart of ``dist_gnn_tpu/parallel/host_struct.py`` (``DistHostCSCStore``,
lines 39-238), after the reference's per-row local/peer/host routing
(``rowwise_sampling_p2p.cu:180-223``) with the host tier made explicit:

  tier 1    this rank's hot rows, a sub-CSC on its device built from
            ``hot_ids[rank]`` (the cache plan's row for this rank), sampled
            by K6, or on a weighted graph by K8 from the sub-CSC's own
            alias tables;
  tier 2/3  the CSC in host memory; each hop's miss rows are staged from
            it (``host_tier.plan_hop_arrays``: a compact sub-CSC of the rows
            up to ``deg_cap`` wide, sampled by K6 or K7 on the device, and
            the hub rows presampled on the host).

The JAX package plans every chip of the mesh in one process from one
``[n, L]`` seed matrix.  Here each rank is a process: :meth:`plan_hop`
takes this rank's ``[L]`` seeds and reads its own copy of the host CSC
(a ``np.memmap`` serves as well as an array).  It draws the n per-chip
seeds of the hub presampling from ``rng`` as JAX does and takes its own,
so every rank's picks equal JAX's on that chip, and ``rng`` stays in step
on every rank.

A hop is lossless: a rank whose misses exceed ``miss_budget`` plans again
with the budget doubled past them (JAX grows every chip's budget to the
largest chip's need; a rank here grows only its own, which stages the same
rows).  Per hop it reports the staged rows (``count``), the rows staged
beyond the configured budget (``overflow``) and the staged rows of
another host's node range (``remote``: a real multi-host job would read
those over the network).  On the flat mesh each rank is its own host
(``num_hosts = n``, ``peer_size = 1``); on the two-tier ``('host',
'data')`` mesh the node ranges are per host (``num_hosts = H``,
``peer_size = D``), as in JAX's.
"""

from __future__ import annotations

import numpy as np

import torch

from dist_gnn_tpu_torch.host_tier import HostCSCStore
from dist_gnn_tpu_torch.ops.hashtable import np_in_sorted
from dist_gnn_tpu_torch.parallel.mesh import Mesh, check_axis


def check_plan(hot_ids: np.ndarray, mesh: Mesh) -> np.ndarray:
    """``hot_ids`` as an [n, C] int32 plan with one row per rank."""
    hot_ids = np.asarray(hot_ids, np.int32)
    if hot_ids.ndim != 2 or hot_ids.shape[0] != mesh.size:
        raise ValueError(f"hot_ids of shape {hot_ids.shape} is not one row per rank of {mesh.size}")
    return hot_ids


class DistHostCSCStore(HostCSCStore):
    """This rank's hot sub-CSC on its device and the host CSC, staged per
    hop (module doc).  ``hot_ids`` is the [n, C] per-rank structure plan
    (selfish or selfless, ``cache/builder.build_cache_plan``), INVALID
    padded; ``miss_budget`` sizes a hop's staged rows, past which it
    re-plans.  ``axis_name``: ``'data'`` or, on a two-tier mesh,
    ``('host', 'data')``."""

    def __init__(self, hg, mesh: Mesh, hot_ids: np.ndarray, miss_budget: int, deg_cap: int = 128,
                 axis_name="data"):
        self.axis_name, self.hierarchical = check_axis(mesh, axis_name)
        hot_ids = check_plan(hot_ids, mesh)
        super().__init__(hg, hot_ids[mesh.rank], miss_budget, deg_cap=deg_cap, device=mesh.device)
        self.mesh = mesh
        self.num_shards = mesh.size
        self.num_nodes = int(hg.num_nodes)
        # node-range ownership (whose host memory holds a row): per host
        self.num_hosts, self.peer_size = mesh.shape if self.hierarchical else (mesh.size, 1)
        self.rows_per_part = -(-self.num_nodes // self.num_hosts)  # owner host = id // rows_per_part

    def hit_rate(self, seeds_np: np.ndarray) -> float:
        """Share of the seeds of every rank in its rank's hot rows: this
        rank's ``seeds_np`` [L] (every entry, as JAX's counts its [n, L]
        matrix) summed with the others' by one all-reduce, so ranks of
        unequal L weigh by their L.  Every rank calls it."""
        hits = float(np.sum(np_in_sorted(self.sorted_np, seeds_np)[0]))
        tot = torch.tensor([hits, float(len(seeds_np))], dtype=torch.float64, device=self.mesh.device)
        if self.mesh.size > 1:
            tot = self.mesh.all_reduce(tot)
        return float(tot[0]) / max(float(tot[1]), 1.0)

    def plan_hop(self, seeds_np: np.ndarray, mask_np: np.ndarray, k: int, rng: np.random.Generator):
        """Probe this rank's hot rows and stage the misses' adjacency for
        its ``seeds_np`` [L].  Returns ``(local_rows_np [L],
        StagedAdjacency)`` with the hop's ``count``, ``overflow`` and
        ``remote`` (module doc).  Every rank calls it with the same
        ``rng`` state (``host_struct.py:180``: n draws per hop)."""
        L = len(seeds_np)
        forks = [rng.integers(0, 2**63 - 1) for _ in range(self.num_shards)]
        mine = forks[self.mesh.rank]

        def plan(budget):
            return self._plan(seeds_np, mask_np, k, np.random.default_rng(mine), budget)

        local_rows, a, m, ovf = plan(self.miss_budget)
        need = m + ovf
        if need > self.miss_budget:  # lossless: plan again with room for every miss
            budget = max(self.miss_budget, 1)  # a budget of 0 must grow too
            while budget < need:
                budget *= 2
            local_rows, a, m, ovf = plan(min(budget, L))
        staged_seeds = np.asarray(seeds_np)[a["row_of"]].astype(np.int64)
        remote = int(np.sum(staged_seeds // self.rows_per_part != self.mesh.rank // self.peer_size))
        # after a re-plan ovf is 0; the overflow reports the rows staged
        # beyond the configured budget (served, not dropped)
        return local_rows, self._staged(a, m, ovf + max(0, m - self.miss_budget), remote)
