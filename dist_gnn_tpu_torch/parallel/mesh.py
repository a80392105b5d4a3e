"""Process group, rank and device of a distributed run.

Counterpart of ``dist_gnn_tpu/parallel/mesh.py``.  The JAX package names
one global ``Mesh`` and lets the compiler schedule its collectives; here
every rank is a process of its own in a ``torch.distributed`` group, and
:class:`Mesh` holds the group, this rank, the world size and this rank's
device.  The one axis is ``data``: data parallelism over seeds and
node-range sharding of the feature and structure stores.  The two-tier
``('host', 'data')`` mesh waits with the hierarchical exchange.

Backends: NCCL for a CUDA device, gloo for the CPU, or gloo on CUDA when
the caller names it (gloo then carries CUDA tensors through the host).
No backend is ever chosen behind the caller's back.

Every collective of the port goes through a :class:`Mesh` method, which
counts it in ``Mesh.counts``; a count read back to the host (the lossless
exchanges' pending count) is a host sync and counted as one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device

COUNTS = ("all_to_all", "all_reduce", "all_gather", "p2p", "host_syncs")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the group: ``rank`` in ``[0, size)``, its
    ``device``, and the process ``group`` (None: the default group)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    counts: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(COUNTS, 0))

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(COUNTS, 0)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block ``i`` of ``x`` ([size, ...], split on dim 0) goes to rank
        ``i``; block ``j`` of the result came from rank ``j``."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading dim of {self.size}, got {tuple(x.shape)}")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self.counts["all_to_all"] += 1
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, group=self.group)
        self.counts["all_reduce"] += 1
        return x

    def sum_to_host(self, x: torch.Tensor) -> int:
        """The sum of the 0-d integer ``x`` over the ranks, read back: one
        all-reduce and one host sync."""
        total = self.all_reduce(x.reshape(1).to(torch.int64))
        self.counts["host_syncs"] += 1
        return int(total.item())

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (all of one shape), in rank order."""
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        self.counts["all_gather"] += 1
        return out

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """One step of the ring: ``x`` goes to rank ``rank - 1`` and the
        block of rank ``rank + 1`` comes back (the JAX package's
        ``ppermute`` with ``perm [(i, i - 1)]``)."""
        if self.size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (self.rank - 1) % self.size, group=self.group),
               dist.P2POp(dist.irecv, out, (self.rank + 1) % self.size, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.counts["p2p"] += 1
        return out


def make_mesh(device: DeviceLike = None, group=None) -> Mesh:
    """The :class:`Mesh` of an initialised process group: this rank, the
    world size and ``device`` (default: the card; the current CUDA device,
    which each rank sets before it places anything there)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (initialize_distributed)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group), device=dev, group=group)


def axis_size(mesh: Mesh, axis: Optional[str] = None) -> int:
    """Size of the mesh's one axis (``'data'``)."""
    return mesh.size


def initialize_distributed(
    init_method: str,
    rank: int,
    world_size: int,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    local_rank: Optional[int] = None,
    timeout_s: float = 300.0,
) -> Mesh:
    """Join the process group and return this rank's :class:`Mesh`.

    ``device`` defaults to the card.  On CUDA the rank first makes
    ``cuda:local_rank`` (default ``rank`` modulo the visible cards) its
    current device, so every kernel launches there.  ``backend`` defaults
    to NCCL on CUDA and gloo on the CPU; ``'gloo'`` on CUDA is taken as
    asked.  ``init_method`` is a ``tcp://host:port`` or ``file://path``
    rendezvous: nothing tells a program of its cluster, so the caller
    names it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = local_rank if local_rank is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    be = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if be == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    dist.init_process_group(
        be, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return make_mesh(dev)


def replicate_to_mesh(tree, mesh: Mesh):
    """Host values (numpy arrays or tensors, in dicts, lists and tuples)
    placed on this rank's device.  Every rank must hold the same values, as
    the JAX package's ``replicate_to_mesh`` requires."""
    if isinstance(tree, dict):
        return {k: replicate_to_mesh(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_to_mesh(v, mesh) for v in tree)
    return torch.as_tensor(np.asarray(tree) if not isinstance(tree, torch.Tensor) else tree).to(mesh.device)


def _child(fn, rank, world_size, init_method, backend, device, args, timeout_s, results) -> None:
    torch.set_num_threads(1)
    try:
        mesh = initialize_distributed(init_method, rank, world_size, backend, device, timeout_s=timeout_s)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:  # noqa: BLE001 — every failure goes back to the launcher
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(
    fn: Callable,
    world_size: int,
    args: Sequence = (),
    backend: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: float = 120.0,
) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned processes, one rank
    each, and return their results in rank order (the counterpart of
    ``initialize_cpu_cluster``).  ``device`` defaults to the card and
    raises without one; ``device="cpu"`` gives a gloo world on the CPU.

    The ranks meet through a ``file://`` rendezvous in a fresh temporary
    directory.  ``fn`` and ``args`` must pickle, as must each result (so
    return numpy arrays or CPU tensors).  Every rank's failure comes back
    with its traceback; the launcher raises on the first one, or when
    ``timeout_s`` passes, and kills every process it started either way."""
    device = str(resolve_device(device))
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dist_gnn_launch_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_child, args=(fn, r, world_size, init_method, backend, device, args, timeout_s, results),
                    daemon=True)
        for r in range(world_size)
    ]
    got: Dict[int, Any] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"timed out after {timeout_s} s with ranks {sorted(got)} done"
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in got]
                if dead:
                    # give a result that is still in flight a moment to land
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result"
                        break
                else:
                    continue
            if ok:
                got[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            p.join(timeout=5 if failure is None else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, world_size={world_size}): {failure}")
    return [got[r] for r in range(world_size)]
