"""Process group, rank and device of a distributed run.

Counterpart of ``dist_gnn_tpu/parallel/mesh.py``.  The JAX package names
one global ``Mesh`` and lets the compiler schedule its collectives; here
every rank is a process of its own in a ``torch.distributed`` group, and
:class:`Mesh` holds the group, this rank, the world size and this rank's
device.  Axes, as the JAX package names them:

  * ``data``: data parallelism over seeds and node-range sharding of the
    feature and structure stores; the flat mesh has only this axis;
  * ``('host', 'data')``: the two-tier mesh of ``make_mesh(hosts=H)``,
    shape ``(H, D)`` with ``D = world // H``.  Rank ``r`` sits at
    ``(r // D, r % D)``, the order of JAX's ``devices.reshape(H, D)``, so
    the flat index of the tuple axis is the rank.  The world ``Mesh``
    stays the flat axis; :meth:`Mesh.axis` gives the two sub-meshes, each
    a ``Mesh`` of its own process group: ``host`` groups the ranks of one
    intra-host index ``d`` (``{d, D + d, ...}``, where JAX's stage-1
    ``all_to_all`` lands) and ``data`` the ranks of one host
    (``{hD, ..., hD + D - 1}``: on H100 nodes the NVLink island).

Backends: NCCL for a CUDA device, gloo for the CPU, or gloo on CUDA when
the caller names it (gloo then carries CUDA tensors through the host).
No backend is ever chosen behind the caller's back.

Every collective of the port goes through a :class:`Mesh` method, which
counts it in ``Mesh.counts``; a count read back to the host (the lossless
exchanges' pending count) is a host sync and counted as one.  Each
sub-mesh counts its own (``Mesh.all_counts``), so host-stage and
data-stage collectives are reported apart.
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device

COUNTS = ("all_to_all", "all_reduce", "all_gather", "p2p", "host_syncs")
TWO_TIER = ("host", "data")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the group: ``rank`` in ``[0, size)``, its
    ``device``, and the process ``group`` (None: the default group).
    ``shape`` is ``(H, D)`` on a two-tier mesh and None on the flat one;
    ``subs`` holds the two-tier mesh's ``host`` and ``data`` sub-meshes
    (:func:`make_mesh` builds them)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    counts: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(COUNTS, 0))
    shape: Optional[Tuple[int, int]] = None
    subs: Dict[str, "Mesh"] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.shape is not None and self.shape[0] * self.shape[1] != self.size:
            raise ValueError(f"a mesh of shape {self.shape} has {self.size} ranks")

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def two_tier(self) -> bool:
        return self.shape is not None

    def axis(self, name) -> "Mesh":
        """The sub-mesh of one axis: ``'host'`` or ``'data'`` of a
        two-tier mesh; the mesh itself for the tuple axis, and for
        ``'data'`` on the flat mesh."""
        name = tuple(name) if isinstance(name, (tuple, list)) else name
        if name == TWO_TIER and self.two_tier or name == "data" and not self.two_tier:
            return self
        if name not in TWO_TIER or not self.two_tier:
            raise ValueError(f"axis {name!r} of a mesh of shape {self.shape or (self.size,)}")
        if name not in self.subs:
            raise ValueError("this mesh has no process groups for its axes: make_mesh(hosts=H) builds them")
        return self.subs[name]

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(COUNTS, 0)
        for sub in self.subs.values():
            sub.reset_counts()

    def all_counts(self) -> Dict[str, Dict[str, int]]:
        """The counts of the world (flat) axis and of each sub-mesh."""
        return {"world": dict(self.counts), **{k: dict(m.counts) for k, m in self.subs.items()}}

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


def make_mesh(device: DeviceLike = None, group=None, hosts: Optional[int] = None) -> Mesh:
    """The :class:`Mesh` of an initialised process group: this rank, the
    world size and ``device`` (default: the card; the current CUDA device,
    which each rank sets before it places anything there).

    ``hosts=H`` makes the two-tier ``('host', 'data')`` mesh of shape
    ``(H, world // H)`` (module doc) and its two sub-meshes.  Every rank
    must call it, in the same order as its other group calls: each
    sub-group is made by ``dist.new_group``, which every rank of the world
    calls for every sub-group, its own or not.  A sub-group that spans the
    whole world reuses ``group``, so a world of one, the mesh ``(1, 1)``,
    makes none."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (initialize_distributed)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if hosts is None:
        return Mesh(rank=rank, size=size, device=dev, group=group)
    if hosts < 1 or size % hosts:
        raise ValueError(f"{size} ranks do not split into {hosts} hosts")
    H, D = hosts, size // hosts
    world = dist.get_process_group_ranks(group) if group is not None else list(range(size))

    def new_group(members: List[int]):
        return group if len(members) == size else dist.new_group([world[i] for i in members])

    # the same order on every rank: the host groups, then the data groups
    host_groups = [new_group([h * D + d for h in range(H)]) for d in range(D)]
    data_groups = [new_group([h * D + d for d in range(D)]) for h in range(H)]
    subs = {"host": Mesh(rank=rank // D, size=H, device=dev, group=host_groups[rank % D]),
            "data": Mesh(rank=rank % D, size=D, device=dev, group=data_groups[rank // D])}
    return Mesh(rank=rank, size=size, device=dev, group=group, shape=(H, D), subs=subs)


def axis_size(mesh: Mesh, axis=None) -> int:
    """Size of a (possibly tuple) mesh axis: ``'host'`` H, ``'data'`` D
    (the world on the flat mesh), ``('host', 'data')`` H·D; None is the
    world."""
    if axis is None:
        return mesh.size
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= axis_size(mesh, a)
        return n
    if not mesh.two_tier:
        if axis != "data":
            raise ValueError(f"the flat mesh has no axis {axis!r}")
        return mesh.size
    if axis not in TWO_TIER:
        raise ValueError(f"the two-tier mesh has no axis {axis!r}")
    return mesh.shape[TWO_TIER.index(axis)]


def check_axis(mesh: Mesh, axis_name) -> Tuple[Any, bool]:
    """``(axis_name, two_tier)`` of a store's axis: ``'data'`` on the flat
    mesh, ``('host', 'data')`` (a list is taken as a tuple) on the
    two-tier one.  Either shards over the whole world; ``'data'`` alone on
    a two-tier mesh (JAX's replication over hosts) is not ported."""
    ax = tuple(axis_name) if isinstance(axis_name, list) else axis_name
    if ax not in ("data", TWO_TIER):
        raise ValueError(f"axis_name {axis_name!r}: the port takes 'data' or ('host', 'data')")
    if (ax == TWO_TIER) != mesh.two_tier:
        raise ValueError(f"axis_name {ax!r} on a mesh of shape {mesh.shape or (mesh.size,)}: "
                         "('host', 'data') goes with make_mesh(hosts=H), 'data' with the flat mesh")
    return ax, ax == TWO_TIER


def initialize_distributed(
    init_method: str,
    rank: int,
    world_size: int,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    local_rank: Optional[int] = None,
    timeout_s: float = 300.0,
    hosts: Optional[int] = None,
) -> Mesh:
    """Join the process group and return this rank's :class:`Mesh` (the
    two-tier mesh of ``hosts`` hosts when given, :func:`make_mesh`).

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
    return make_mesh(dev, hosts=hosts)


def replicate_to_mesh(tree, mesh: Mesh):
    """Host values (numpy arrays or tensors, in dicts, lists and tuples)
    placed on this rank's device.  Every rank must hold the same values, as
    the JAX package's ``replicate_to_mesh`` requires."""
    if isinstance(tree, dict):
        return {k: replicate_to_mesh(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_to_mesh(v, mesh) for v in tree)
    return torch.as_tensor(np.asarray(tree) if not isinstance(tree, torch.Tensor) else tree).to(mesh.device)


def _child(fn, rank, world_size, init_method, backend, device, args, timeout_s, hosts, results, local) -> None:
    torch.set_num_threads(1)
    try:
        # the card of this launcher's ``local``-th rank: ranks of one host
        # take its cards in turn, whatever their global numbers
        local_rank = local % torch.cuda.device_count() if device.startswith("cuda") else None
        mesh = initialize_distributed(init_method, rank, world_size, backend, device, local_rank=local_rank,
                                      timeout_s=timeout_s, hosts=hosts)
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
    hosts: Optional[int] = None,
    init_method: Optional[str] = None,
    ranks: Optional[Sequence[int]] = None,
) -> List[Any]:
    """Run ``fn(mesh, *args)`` on spawned processes, one rank each, and
    return their results in rank order (the counterpart of
    ``initialize_cpu_cluster``).  ``device`` defaults to the card and
    raises without one; ``device="cpu"`` gives a gloo world on the CPU.
    ``hosts`` makes ``mesh`` the two-tier mesh (:func:`make_mesh`).

    By default this call starts every rank of the world, and they meet
    through a ``file://`` rendezvous in a fresh temporary directory.  A
    world that spans hosts runs one launcher per host, each with its own
    ``ranks`` (the global ranks it starts; its ``i``-th rank takes card
    ``i`` modulo the visible cards) and the same ``init_method``, a
    ``tcp://host:port`` every host reaches; results come back for
    ``ranks``.  ``fn`` and ``args`` must pickle, as must each result (so
    return numpy arrays or CPU tensors).  Every rank's failure comes back
    with its traceback; the launcher raises on the first one, or when
    ``timeout_s`` passes (also the process group's timeout), and kills
    every process it started either way."""
    device = str(resolve_device(device))
    ranks = list(range(world_size)) if ranks is None else [int(r) for r in ranks]
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dist_gnn_launch_")
    init_method = init_method or "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_child, daemon=True,
                    args=(fn, r, world_size, init_method, backend, device, args, timeout_s, hosts, results, i))
        for i, r in enumerate(ranks)
    ]
    got: Dict[int, Any] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < len(ranks) and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"timed out after {timeout_s} s with ranks {sorted(got)} done"
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p) for r, p in zip(ranks, procs) if p.exitcode is not None and r not in got]
                if dead:
                    # give a result that is still in flight a moment to land
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = f"rank {dead[0][0]} exited with code {dead[0][1].exitcode} and no result"
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
    return [got[r] for r in ranks]
