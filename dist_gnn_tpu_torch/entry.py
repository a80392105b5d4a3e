"""Entry points: the port's counterpart of the JAX package's
``__graft_entry__.py``.

``entry()``              the forward step of the flagship model (GraphSAGE
                         over sampled blocks) on one device, as a callable
                         and its example arguments.
``dryrun_multichip(n)``  one full distributed training step of every plane
                         on ``n`` ranks spawned by ``parallel.mesh.launch``:
                         the two-tier ``('host', 'data')`` mesh with two
                         hosts when ``n >= 4`` and even (else the flat
                         mesh), seeds data-parallel over the world, the
                         structure node-range sharded with heat-planned hot
                         tiers and owner-side sampling, the features
                         sharded with hot rows, intra-host peer-hot rows and
                         the hierarchical exchange; then a weighted step on
                         an int8 store (K8), a GAT step (K4/K5) and one
                         ``DistHostTrainer`` batch over host-resident
                         features and structure.

Both default to the card and raise without one; ``device="cpu"`` runs on
the CPU (``dryrun_multichip`` then spawns a gloo world).  The TPU window
knobs of JAX's dryrun (``sampler_window``, ``sampler_big_budget``) are
not carried over: the port's weighted sampler is K8 where JAX's is
windowed.  Run as a script, it calls ``entry`` and ``dryrun_multichip(4,
backend="gloo")`` on the card::

    python3 -m dist_gnn_tpu_torch.entry
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device


def _tiny_problem(num_nodes=512, feature_dim=32, num_classes=8, seed=0):
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph

    arrays, meta = make_synthetic_dataset(
        num_nodes=num_nodes, avg_degree=6, feature_dim=feature_dim, num_classes=num_classes, seed=seed,
    )
    return arrays, meta, HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])


def entry(device: DeviceLike = None):
    """``(fn, example_args)``: the fused forward step (sample every layer,
    gather the features, run GraphSAGE in eval mode) on one device, with
    ``fn(params, graph, features, seeds, seed_mask, generator) -> logits``;
    ``params`` is a state_dict."""
    from dist_gnn_tpu_torch.models import SAGE
    from dist_gnn_tpu_torch.ops.gather import gather_rows
    from dist_gnn_tpu_torch.sampler import sample_blocks

    dev = resolve_device(device)
    arrays, meta, hg = _tiny_problem()
    graph = hg.to_device(dev)
    features = torch.from_numpy(arrays["features"]).to(dev)
    model = SAGE(meta["feature_dim"], 64, meta["num_classes"], 2, dropout=0.0,
                 generator=torch.Generator().manual_seed(0), device=dev)
    fan_out = (5, 5)

    @torch.inference_mode()
    def fwd(params, graph, features, seeds, seed_mask, generator):
        blocks, _ = sample_blocks(graph, seeds, seed_mask, fan_out, False, generator)
        inp = blocks[-1]
        feats = gather_rows(features, torch.where(inp.frontier_mask, inp.frontier, 0))
        feats = torch.where(inp.frontier_mask[:, None], feats, 0)
        return functional_call(model, dict(params), (tuple(reversed(blocks)), feats))

    B = 64
    train = np.asarray(arrays["train_idx"])
    seeds = torch.from_numpy(train[np.arange(B) % len(train)].astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    example_args = (dict(model.state_dict()), graph, features, seeds, torch.ones(B, dtype=torch.bool, device=dev), gen)
    return fwd, example_args


def dryrun_rank(mesh) -> Dict[str, Any]:
    """One rank of :func:`dryrun_multichip` on ``mesh`` (two-tier when it
    has a shape, else flat): every plane's step, each loss checked finite.
    Returns the metrics the summary line prints, from this rank."""
    from dist_gnn_tpu_torch.cache.autotune import tune_dist_tier
    from dist_gnn_tpu_torch.cache.builder import build_cache_plan
    from dist_gnn_tpu_torch.dataloading.preprocess import add_random_probs
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models import GAT, SAGE
    from dist_gnn_tpu_torch.parallel.feature_store import ShardedFeatureStore
    from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph
    from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
    from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore
    from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer

    n, dev, two_tier = mesh.size, mesh.device, mesh.two_tier
    ax = ("host", "data") if two_tier else "data"
    arrays, meta, hg = _tiny_problem(num_nodes=max(256, 8 * n))
    fan_out = (4, 3)
    parts = np.array_split(arrays["train_idx"], n)
    _, s_hot, f_hot = build_cache_plan(hg, meta["feature_dim"], parts, fan_out, capacity_bytes=10_000,
                                       policy="auto", device=dev)
    B = 8 * n
    tier = tune_dist_tier(arrays["indptr"], arrays["indices"], arrays["train_idx"], max(1, B // n), fan_out, n,
                          hot_ids=s_hot, num_nodes=meta["num_nodes"])
    sgraph = ShardedGraph.build(hg, mesh, axis_name=ax, hot_ids=s_hot)
    store = ShardedFeatureStore(arrays["features"], mesh, axis_name=ax, hot_ids=f_hot, hierarchical=two_tier,
                                peer_hot=True, budget_slack=tier.exchange_slack)
    labels = store.shard_of(np.asarray(arrays["labels"], np.int32)[:, None])
    train = np.asarray(arrays["train_idx"])
    seeds = torch.from_numpy(train[np.arange(B) % len(train)].astype(np.int32)).to(dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    F, C = meta["feature_dim"], meta["num_classes"]

    def step(model, seed, **kw):
        trainer = DistTrainer(model=model, fan_out=fan_out, **kw)
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + mesh.rank)
        m = trainer.train_step(None, labels, seeds, mask, gen)
        m = {k: float(v) for k, v in m.items()}
        if not np.isfinite(m["loss"]):
            raise FloatingPointError(f"dryrun_multichip: a non-finite loss {m['loss']} (rank {mesh.rank})")
        return m

    def sage(seed):  # the same parameters on every rank
        return SAGE(F, 32, C, 2, dropout=0.5, generator=torch.Generator().manual_seed(seed), device=dev)

    metrics = step(sage(0), 2, store=store, sgraph=sgraph)
    # weighted plane: per-edge weights with alias tables (K8) on an int8 peer-hot store
    hg_b = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"],
                     probs=add_random_probs(int(meta["num_edges"]), seed=5))
    sgraph_b = ShardedGraph.build(hg_b, mesh, axis_name=ax, hot_ids=s_hot)
    store_q = ShardedFeatureStore(arrays["features"], mesh, axis_name=ax, hot_ids=f_hot, hierarchical=two_tier,
                                  peer_hot=True, quantize=True)
    metrics_b = step(sage(10), 11, store=store_q, sgraph=sgraph_b)
    # GAT plane: the fused attention kernels (K4/K5) on every layer
    gat = GAT(F, 128, C, 2, num_heads=4, dropout=0.5, generator=torch.Generator().manual_seed(12), device=dev)
    metrics_g = step(gat, 13, store=store, sgraph=sgraph, dedup_last=False)
    # host-resident features and structure on the same mesh: one batch
    gstore = DistHostCSCStore(hg, mesh, s_hot, miss_budget=tier.struct_miss_budget, deg_cap=tier.deg_cap,
                              axis_name=ax)
    hstore = DistHostFeatureStore(arrays["features"], mesh, f_hot, miss_budget=tier.feat_miss_budget, axis_name=ax)
    htrainer = DistHostTrainer(model=sage(3), fan_out=fan_out, store=hstore, gstore=gstore, dedup_last=False)
    hmetrics = htrainer.train_batches(None, np.asarray(arrays["labels"]),
                                      [(seeds.cpu().numpy(), mask.cpu().numpy())], 4)[0]
    if not np.isfinite(float(hmetrics["loss"])):
        raise FloatingPointError(f"dryrun_multichip: a non-finite host-tier loss (rank {mesh.rank})")
    shape = dict(zip(("host", "data"), mesh.shape)) if two_tier else {"data": n}
    return {
        "mesh": shape, "loss": metrics["loss"], "acc": metrics["acc"], "overflow": int(metrics["overflow"]),
        "sampler_overflow": int(metrics["sampler_overflow"]), "biased_q_loss": metrics_b["loss"],
        "biased_overflow": int(metrics_b["overflow"]), "gat_loss": metrics_g["loss"],
        "dist_host_loss": float(hmetrics["loss"]), "struct_miss": int(hmetrics["struct_miss"]),
        "feat_miss": int(hmetrics["feat_miss"]), "peer_dropped": int(hmetrics["peer_dropped"]),
    }


def summary_line(n_devices: int, m: Dict[str, Any]) -> str:
    """The JAX package's summary line of ``dryrun_multichip``."""
    return (
        f"dryrun_multichip({n_devices}): ok — mesh={m['mesh']} "
        f"loss={m['loss']:.4f} acc={m['acc']:.4f} overflow={m['overflow']} "
        f"sampler_overflow={m['sampler_overflow']} biased_q_loss={m['biased_q_loss']:.4f} "
        f"biased_overflow={m['biased_overflow']} gat_loss={m['gat_loss']:.4f} "
        f"dist_host_loss={m['dist_host_loss']:.4f} struct_miss={m['struct_miss']} feat_miss={m['feat_miss']}"
    )


def dryrun_multichip(n_devices: int, device: DeviceLike = None, backend: Optional[str] = None) -> Dict[str, Any]:
    """One full distributed training step of every plane on ``n_devices``
    spawned ranks (module doc); prints the summary line and returns rank
    0's metrics.  ``device`` defaults to the card (every rank on it; NCCL
    needs a card a rank, so one card takes ``backend="gloo"``).  A rank's
    failure raises with its traceback."""
    from dist_gnn_tpu_torch.parallel.mesh import launch

    two_tier = n_devices >= 4 and n_devices % 2 == 0
    res = launch(dryrun_rank, n_devices, backend=backend, device=device, timeout_s=600.0,
                 hosts=2 if two_tier else None)
    print(summary_line(n_devices, res[0]), flush=True)
    return res[0]


if __name__ == "__main__":
    # through the package's module, so the spawned ranks unpickle its dryrun_rank
    from dist_gnn_tpu_torch import entry as _entry

    fn, args = _entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry(): ok, logits", tuple(out.shape))
    _entry.dryrun_multichip(4, backend="gloo")
