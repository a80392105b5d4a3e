"""Bandwidth/byte cost model for cache admission.

Counterpart of ``dist_gnn_tpu/cache/cost_model.py``.  The reference
hardcodes measured constants (``node_classification.py:79-85``) and values
caching a row by ``bytes_slow / BW_slow - bytes_fast / BW_fast``
(``cache_value.py:221-222``).  Three tiers:

* hbm  — a gather from the card's own memory (the cached fast path);
* peer — a read from another card's memory (the partitioned "selfless"
  tier), kept under its JAX name ``bandwidth_ici``; :func:`calibrate_ici`
  measures it as an all-to-all over the process group (over NCCL between
  cards; a gloo group, on one card, measures the host path instead);
* host — the miss path: a host-memory row gather plus the host → device
  copy.

The defaults are placeholders, not measurements of any device:
:func:`calibrate` measures the hbm figure on the card (K1 on random rows)
and :func:`calibrate_host_staging` the host figure.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class CostModel:
    bandwidth_hbm: float = 800e9  # bytes/s, local device-memory gather (placeholder)
    bandwidth_ici: float = 45e9  # bytes/s, peer-card read (placeholder)
    bandwidth_host: float = 10e9  # bytes/s, host miss tier (placeholder)
    # measured legs of the host staging path (calibrate_host_staging);
    # bandwidth_host is their effective serial rate
    staging_gather_bandwidth: float = 0.0  # bytes/s, host-memory row gather
    staging_h2d_bandwidth: float = 0.0  # bytes/s, host → device copy
    sampling_read_bytes_fast: float = 480.0  # per seed, structure cached
    sampling_read_bytes_slow: float = 480.0  # per seed, structure on the miss tier
    feature_read_bytes_fast: float = 480.0  # per node, features cached
    feature_read_bytes_slow: float = 512.0  # per node, features on the miss tier

    def sampling_reduced_time(self) -> float:
        """Seconds saved per unit heat by caching a node's structure
        (``cache_value.py:221``)."""
        return (
            self.sampling_read_bytes_slow / self.bandwidth_host
            - self.sampling_read_bytes_fast / self.bandwidth_hbm
        )

    def feature_reduced_time(self) -> float:
        return (
            self.feature_read_bytes_slow / self.bandwidth_host
            - self.feature_read_bytes_fast / self.bandwidth_hbm
        )

    def local_bandwidth_selfless(self, num_devices: int) -> float:
        """Effective local bandwidth when peers also read
        (``cache_value.py:363``), floored at the peer bandwidth so that the
        linear contention model never goes negative."""
        return max(
            self.bandwidth_hbm - (num_devices - 1) * self.bandwidth_ici,
            self.bandwidth_ici,
        )


def available_hbm_bytes(device: DeviceLike = None, reserved: int = 2 << 30) -> int:
    """Free memory on the card less ``reserved`` bytes of headroom
    (``torch.cuda.mem_get_info``): the cache-capacity input, replacing the
    reference's ``get_available_memory`` (``cache_value.py:412-417``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"{dev} has no device memory to size a cache from")
    free, _ = torch.cuda.mem_get_info(dev)
    return max(int(free) - reserved, 0)


def _copy_seconds(fn, dev: torch.device, reps: int) -> float:
    """Least seconds of ``reps`` calls of ``fn`` (after one warm-up): CUDA
    events around each call on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best


def calibrate_host_staging(
    feature_dim: int = 128,
    base_rows: int = 1 << 18,
    batch_rows: int = 1 << 14,
    reps: int = 5,
    cm: Optional[CostModel] = None,
    device: DeviceLike = None,
) -> CostModel:
    """Measure the host staging tier on ``device`` (default: the card): the
    native host row gather (``utils/native.gather_rows``, host clock) and
    the copy of the gathered rows from pinned memory to the device, timed
    by the size slope (two copy sizes, so the fixed cost of a copy
    cancels; CUDA events on the card).  Sets ``cm.bandwidth_host`` to the
    serial rate of the two legs, which one batch's staging runs back to
    back, and records each leg."""
    from dist_gnn_tpu_torch.utils import native

    dev = resolve_device(device)
    cm = cm or CostModel()
    rng = np.random.default_rng(0)
    base = rng.standard_normal((base_rows, feature_dim)).astype(np.float32)
    ids = rng.integers(0, base_rows, batch_rows).astype(np.int64)
    pinned = torch.empty((batch_rows, feature_dim), dtype=torch.float32, pin_memory=dev.type == "cuda")
    out = pinned.numpy()

    native.gather_rows(base, ids, out=out)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        native.gather_rows(base, ids, out=out)
    gather_dt = (time.perf_counter() - t0) / reps

    def h2d_seconds(r: int) -> float:
        src = pinned[:r]
        return _copy_seconds(lambda: src.to(dev, non_blocking=True, copy=True), dev, reps)

    r1, r2 = max(batch_rows // 4, 1), batch_rows
    slope_dt = max(h2d_seconds(r2) - h2d_seconds(r1), 1e-9)
    h2d_bw = (r2 - r1) * feature_dim * 4 / slope_dt
    gather_bw = batch_rows * feature_dim * 4 / max(gather_dt, 1e-9)
    cm.staging_gather_bandwidth = gather_bw
    cm.staging_h2d_bandwidth = h2d_bw
    cm.bandwidth_host = 1.0 / (1.0 / gather_bw + 1.0 / h2d_bw)
    return cm


def calibrate(feature_dim: int = 128, rows: int = 1 << 17, device: DeviceLike = None) -> CostModel:
    """Measure the random-row gather bandwidth of the card's memory with
    K1 (``ops/gather.gather_rows``) over a [rows, feature_dim] f32 table,
    timed by CUDA events; bytes are the rows read and written.  The peer
    and host tiers keep their values.  Needs the card."""
    from dist_gnn_tpu_torch.ops.gather import gather_rows
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("calibrate measures the card; it has no CPU form")
    cm = CostModel()
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((rows, feature_dim), generator=gen, device=dev)
    idx = torch.randint(0, rows, (rows,), generator=gen, device=dev, dtype=torch.int32)
    ms = cuda_time_ms(lambda: gather_rows(table, idx))
    cm.bandwidth_hbm = rows * feature_dim * 4 * 2 / (ms / 1e3)
    return cm


def calibrate_ici(mesh=None, axis_name="data", mbytes: int = 8) -> float:
    """Bytes per second per link of a tiled all-to-all over the mesh axis
    ``axis_name`` (``dist_gnn_tpu/cache/cost_model.py:89-119``): the ranks
    of the axis together hold ``mbytes`` MiB of f32 rows, each rank's block
    is split into one chunk per rank and exchanged (``Mesh.all_to_all`` on
    the axis' sub-mesh), and the chain of exchanges is timed by the slope
    method (``utils/timing.measure_chain``, 3 and 12 deep).  The bytes that
    cross a link are the ``(n - 1) / n`` of the total that leave their
    rank.  An axis of one rank returns ``CostModel.bandwidth_ici``.  On a
    two-tier mesh ``'host'`` and ``'data'`` give the slow tier's and the
    fast tier's figure apart; ``'data'`` on the flat mesh is the world.
    ``mesh`` defaults to ``make_mesh()``; every rank of the axis calls it
    (it runs collectives)."""
    from dist_gnn_tpu_torch.parallel.mesh import make_mesh
    from dist_gnn_tpu_torch.utils.timing import measure_chain

    mesh = (mesh or make_mesh()).axis(axis_name)
    n = mesh.size
    if n < 2:
        return CostModel.bandwidth_ici
    rows = mbytes * (1 << 20) // 512 // n * n  # JAX's global row count
    chunk = max(rows // n // n, 1)  # this rank's rows bound for each rank
    x = torch.zeros((n, chunk, 128), dtype=torch.float32, device=mesh.device)
    dt = measure_chain(lambda blk: mesh.all_to_all(blk) + 1.0, x, n_lo=3, n_hi=12)
    total_bytes = n * n * chunk * 128 * 4
    return total_bytes * (n - 1) / n / dt
