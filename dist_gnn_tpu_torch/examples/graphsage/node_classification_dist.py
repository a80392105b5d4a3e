"""Multi-process distributed node classification — the torchrun analog.

Counterpart of the JAX package's ``examples/graphsage/node_classification_dist.py``:
a world of ranks on ``torch.distributed``, one process per rank, laid out
as the two-tier ``('host', 'data')`` mesh of ``--procs`` hosts with
``--devices-per-process`` ranks each.  Every rank builds the same seeded
dataset, takes its slice of each global batch, and the step runs sharded
sampling, the hierarchical feature exchange and the gradient all-reduce.

Runs:
  one host (the launcher spawns every rank):
      python -m dist_gnn_tpu_torch.examples.graphsage.node_classification_dist \\
          --procs 2 --devices-per-process 1 --epochs 2 [--cpu]
  several hosts (run on every host R = 0 .. N-1, the same coordinator):
      python -m dist_gnn_tpu_torch.examples.graphsage.node_classification_dist \\
          --procs N --process-id R --coordinator HOST:PORT --devices-per-process D

Host R starts ranks R·D … R·D+D−1 of the world of N·D; they meet at
``tcp://HOST:PORT`` (``parallel.mesh.launch`` with ``init_method`` and
``ranks``).  The ranks run on the card unless ``--cpu`` is given (gloo on
the CPU); the JAX app's ``--tpu`` has no counterpart.  The backend is NCCL
when every rank of a host has a card of its own, and gloo when ranks share
a card (NCCL refuses two ranks on one device; gloo carries their CUDA
tensors through the host).  A rank that fails ends its siblings, and the
launcher raises.  Rank 0 prints; ``main(argv)`` returns rank 0's results
(the first local rank's on a host without rank 0).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2, help="number of hosts in the cluster")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this host's index (multi-host; omit to launch every rank here)")
    ap.add_argument("--coordinator", default=None, help="coordinator HOST:PORT (multi-host, with --process-id)")
    ap.add_argument("--devices-per-process", type=int, default=4, help="ranks per host")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (default: the card)")
    ap.add_argument("--num-nodes", type=int, default=4_000)
    ap.add_argument("--avg-degree", type=int, default=10)
    ap.add_argument("--feature-dim", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=256, help="global batch (rounded to the world size)")
    ap.add_argument("--fan-out", default="10,10")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--model", default="sage", choices=["sage", "gat", "gcn", "transformer"])
    ap.add_argument("--hot-frac", type=float, default=0.1,
                    help="fraction of nodes replicated into per-rank hot tiers")
    ap.add_argument("--tier", default="hbm", choices=["hbm", "dist-host"],
                    help="data plane: all-device sharded stores, or the host-RAM-resident base "
                         "(features AND structure staged per batch)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run_worker(mesh, args_dict: Dict[str, Any]) -> Dict[str, Any]:
    """One rank: train ``epochs`` epochs over this rank's slices of the
    global batches, then the sampled validation accuracy each epoch."""
    from dist_gnn_tpu_torch.cache.builder import build_cache_plan
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models import GAT, GCN, SAGE, GraphTransformer
    from dist_gnn_tpu_torch.parallel import DistTrainer, ShardedFeatureStore
    from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph
    from dist_gnn_tpu_torch.utils.timing import device_sync

    args = argparse.Namespace(**args_dict)
    dev = mesh.device
    rank0 = mesh.rank == 0
    ax = ("host", "data")
    n_dev = mesh.size
    fan_out = tuple(int(x) for x in args.fan_out.split(","))

    # the same seeded dataset on every rank
    arrays, meta = make_synthetic_dataset(
        num_nodes=args.num_nodes, avg_degree=args.avg_degree, feature_dim=args.feature_dim, seed=args.seed,
    )
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])

    # heat-driven hot tiers, one plan for structure and features
    parts = np.array_split(np.asarray(arrays["train_idx"]), n_dev)
    cap = max(1, int(args.num_nodes * args.hot_frac / n_dev)) * (4 * (args.avg_degree + 2) + 4 * args.feature_dim)
    _, s_hot, f_hot = build_cache_plan(hg, meta["feature_dim"], parts, fan_out, capacity_bytes=cap,
                                       policy="selfish", device=dev)
    model_cls = {"sage": SAGE, "gat": GAT, "gcn": GCN, "transformer": GraphTransformer}[args.model]
    model = model_cls(meta["feature_dim"], args.hidden, meta["num_classes"], len(fan_out),
                      generator=torch.Generator().manual_seed(args.seed), device=dev)
    labels_np = np.asarray(arrays["labels"], np.int32)
    if args.tier == "dist-host":
        # host-RAM base for features AND structure, staged per batch into the
        # per-rank hot tiers; the knobs from the batch simulation
        from dist_gnn_tpu_torch.cache.autotune import tune_dist_tier
        from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
        from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore

        tier = tune_dist_tier(arrays["indptr"], arrays["indices"], arrays["train_idx"],
                              max(1, args.batch_size // n_dev), fan_out, n_dev, hot_ids=s_hot,
                              num_nodes=meta["num_nodes"])
        gstore = DistHostCSCStore(hg, mesh, s_hot, miss_budget=tier.struct_miss_budget, deg_cap=tier.deg_cap,
                                  axis_name=ax)
        store = DistHostFeatureStore(arrays["features"], mesh, f_hot, miss_budget=tier.feat_miss_budget,
                                     axis_name=ax)
        trainer = DistHostTrainer(model=model, fan_out=fan_out, store=store, gstore=gstore, dedup_last=False)
        sg = labels_sh = None
    else:
        sg = ShardedGraph.build(hg, mesh, axis_name=ax, hot_ids=s_hot)
        store = ShardedFeatureStore(arrays["features"], mesh, axis_name=ax, hot_ids=f_hot, hierarchical=True)
        labels_sh = store.shard_of(torch.from_numpy(labels_np)[:, None])
        trainer = DistTrainer(model=model, fan_out=fan_out, store=store, sgraph=sg)
    # this rank's keys, seeded from (seed + 1, rank)
    key_seed = int(np.random.SeedSequence([args.seed + 1, mesh.rank]).generate_state(1)[0])
    key = torch.Generator(device=dev).manual_seed(key_seed)
    batch = max(n_dev, args.batch_size // n_dev * n_dev)
    train = np.asarray(arrays["train_idx"], np.int32)
    valid = np.asarray(arrays["valid_idx"], np.int32)
    H, D = mesh.shape
    if rank0:
        print(f"cluster: {H} processes x {D} devices, mesh={{'host': {H}, 'data': {D}}} "
              f"nodes={meta['num_nodes']} edges={meta['num_edges']} model={args.model} batch={batch}", flush=True)

    def pad_batch(ids):
        """A (possibly short) id slice padded to the global batch with
        masked seeds, so a short final slice trains and evaluates too."""
        s = np.zeros(batch, np.int32)
        m = np.zeros(batch, bool)
        s[: len(ids)] = ids
        m[: len(ids)] = True
        return s, m

    def put(a):
        return torch.from_numpy(a).to(dev)

    steps = max(1, -(-len(train) // batch))
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = np.random.default_rng(1000 + epoch).permutation(len(train))
        batches = [pad_batch(train[perm[s * batch : (s + 1) * batch]]) for s in range(steps)]
        if args.tier == "dist-host":
            ms = trainer.train_batches(None, labels_np, batches, args.seed + 1 + epoch)
        else:
            ms = [trainer.train_step(None, labels_sh, put(sel), put(mask_np), key) for sel, mask_np in batches]
        device_sync(list(model.parameters()))
        dt = time.perf_counter() - t0
        loss = float(torch.stack([m["loss"] for m in ms]).mean())
        acc = float(torch.stack([m["acc"] for m in ms]).mean())

        eval_steps = max(1, -(-len(valid) // batch))
        vbatches = [pad_batch(valid[s * batch : (s + 1) * batch]) for s in range(eval_steps)]
        if args.tier == "dist-host":
            correct, total = trainer.eval_batches(None, None, labels_np, vbatches, args.seed + 1)
        else:
            correct = total = 0
            for vsel, vmask in vbatches:
                c, t = trainer.eval_step(None, None, labels_sh, put(vsel), put(vmask), key)
                correct, total = correct + c, total + t
            correct, total = int(correct), int(total)
        val_acc = correct / max(total, 1)
        if rank0:
            print(f"epoch {epoch}: loss={loss:.4f} train_acc={acc:.4f} val_acc={val_acc:.4f} time={dt:.2f}s",
                  flush=True)
        epochs.append({"epoch": epoch, "loss": loss, "train_acc": acc, "val_acc": val_acc, "time_s": dt,
                       "steps": steps})
    if rank0:
        print("done", flush=True)
    return {"rank": mesh.rank, "world": mesh.size, "shape": [H, D], "backend": mesh.backend, "device": str(dev),
            "batch": batch, "num_edges": int(meta["num_edges"]), "epochs": epochs}


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    """Parse ``argv`` (default: the command line), start this host's
    ranks and return the results of its first (module doc)."""
    args = build_parser().parse_args(argv)
    if args.process_id is None and args.coordinator:
        raise SystemExit("--coordinator requires --process-id (multi-host mode)")
    if args.process_id is not None and not args.coordinator:
        raise SystemExit("--process-id requires --coordinator HOST:PORT")
    from dist_gnn_tpu_torch.examples.graphsage import node_classification_dist as app  # importable by the ranks
    from dist_gnn_tpu_torch.examples.graphsage.node_classification import RUN_TIMEOUT_S
    from dist_gnn_tpu_torch.parallel.mesh import launch
    from dist_gnn_tpu_torch.utils.device import resolve_device

    N, D = args.procs, args.devices_per_process
    device = "cpu" if args.cpu else str(resolve_device(None))
    here = N * D if args.process_id is None else D  # the ranks this host starts
    backend = "gloo" if args.cpu or here > torch.cuda.device_count() else "nccl"
    kw = {}
    if args.process_id is not None:
        kw = dict(init_method=f"tcp://{args.coordinator}", ranks=range(args.process_id * D, args.process_id * D + D))
    return launch(app.run_worker, N * D, args=(vars(args),), backend=backend, device=device, hosts=N,
                  timeout_s=RUN_TIMEOUT_S, **kw)[0]


if __name__ == "__main__":
    main()
