"""Mini-batch GraphSAGE/GAT/GCN/graph-transformer node classification — the flagship app.

Counterpart of the JAX package's ``examples/graphsage/node_classification.py``,
with the same options and defaults and the same printed lines:

  correctness (CPU):  python -m dist_gnn_tpu_torch.examples.graphsage.node_classification --cpu --epochs 3
  one card:           ... node_classification --bf16
  every card:         ... node_classification --dist
  weighted sampling:  ... node_classification --bias
  GAT / GCN:          ... node_classification --model gat | --model gcn
  graph transformer:  ... node_classification --model transformer (UniMP's layer; no --full-eval)
  bigger than memory: ... node_classification --tier host [--host-struct]
  3-tier data plane:  ... node_classification --tier dist-host
  a saved dataset:    ... node_classification --dataset <name> --root <dir>

The app runs on the card unless ``--cpu`` is given, and raises without a
card.  ``--dist`` and ``--tier dist-host`` spawn one rank per card
(``parallel.mesh.launch``, NCCL), or two gloo ranks on the CPU with
``--cpu``; rank 0 prints.  ``--unroll U`` runs U steps per
``Trainer.train_step_multi`` call, ``--autotune`` takes the frontier caps
of ``cache.autotune.tune_sampler_for`` (the JAX tuner's window and budget
knobs are TPU layouts), ``--profile`` times the sampling, loading and
whole-step phases with ``utils.timing.measure_chain``.

Keys: the seed order of epoch e is drawn from a CPU generator seeded
``1000 + e``, the epoch's steps from a device generator seeded ``e`` (the
JAX app's ``key(1000 + epoch)`` and ``key(epoch)``); the sampled
validation from one seeded 3.  ``main(argv)`` returns what it printed as a
dict: each epoch's loss, train_acc, val_acc, time_s and steps, the
profile's ms and the full-graph test accuracy.
"""

from __future__ import annotations

import argparse
import copy
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# the launcher waits this long for its ranks (also their process group's timeout)
RUN_TIMEOUT_S = 7 * 24 * 3600.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--root", default="/tmp/dist_gnn_datasets")
    ap.add_argument("--num-nodes", type=int, default=10_000)
    ap.add_argument("--avg-degree", type=int, default=15)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--fan-out", default="10,10")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--model", default="sage", choices=["sage", "gat", "gcn", "transformer"],
                    help="transformer: UniMP's attention layer with a gated residual (sampled evaluation "
                         "only: it has no full-graph pass yet)")
    ap.add_argument("--bias", action="store_true", help="weighted sampling (alias tables)")
    ap.add_argument("--replace", action="store_true")
    ap.add_argument("--bf16", action="store_true", help="bf16 features+compute")
    ap.add_argument("--frontier-caps", default=None, help="comma budgets per hop (sampling order)")
    ap.add_argument("--autotune", action="store_true",
                    help="derive the frontier caps from the graph (cache.autotune.tune_sampler_for; "
                         "overrides --frontier-caps)")
    ap.add_argument("--dist", action="store_true",
                    help="shard over every card (features+structure+DP), one rank each")
    ap.add_argument("--tier", default="hbm", choices=["hbm", "host", "dist-host"],
                    help="feature residency: hbm (default, all on the device), host = host-RAM base + "
                         "device hot tier + staged misses (graphs bigger than device memory), "
                         "dist-host = the same over every card with peer-hot serving")
    ap.add_argument("--hot-frac", type=float, default=0.2,
                    help="fraction of nodes in the device hot tier (tier!=hbm)")
    ap.add_argument("--miss-budget", type=int, default=0, help="staged miss rows per batch (0 = auto)")
    ap.add_argument("--host-struct", action="store_true",
                    help="tier!=hbm: keep the graph TOPOLOGY host-resident too "
                         "(device hot sub-CSC + per-hop staged adjacency)")
    ap.add_argument("--unroll", type=int, default=1,
                    help="run U consecutive steps per Trainer.train_step_multi call "
                         "(single-device hbm tier only)")
    ap.add_argument("--checkpoint", default=None, help="save path prefix")
    ap.add_argument("--resume", default=None, help="load path prefix")
    ap.add_argument("--metrics-log", default=None, help="JSONL metrics path")
    ap.add_argument("--full-eval", action="store_true",
                    help="final full-graph layer-wise inference accuracy (sage, gat, gcn: the transformer "
                         "family has no full-graph pass yet)")
    ap.add_argument("--profile", action="store_true",
                    help="report Sampling/Loading/Training ms per iter (slope-timed phases)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap


def _printer(rank0: bool) -> Callable[..., None]:
    if rank0:
        return lambda *a: print(*a, flush=True)
    return lambda *a: None


def load_data(args):
    """``(arrays, meta, hg)``: the synthetic dataset or ``args.root/
    args.dataset``; the graph's arrays are copied out of the memmaps, the
    features stay as loaded (the host tiers read them in place)."""
    from dist_gnn_tpu_torch.dataloading.preprocess import load_dataset, make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph

    if args.dataset == "synthetic":
        arrays, meta = make_synthetic_dataset(
            num_nodes=args.num_nodes, avg_degree=args.avg_degree, with_probs=args.bias, seed=args.seed,
        )
    else:
        arrays, meta = load_dataset(args.root, args.dataset)
    if args.bias and "probs" not in arrays:
        raise ValueError(f"--bias needs per-edge probs, and dataset {meta['name']!r} has none")
    arrays = {k: (v if k == "features" else np.array(v)) for k, v in arrays.items()}
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"],
                   probs=arrays["probs"] if args.bias else None)
    return arrays, meta, hg


def run_host_tier(args, arrays, meta, hg, model, fan_out, log, dev, mesh, say) -> Dict[str, Any]:
    """Host-resident feature base (graphs bigger than device memory): the
    single-device double-buffered pipeline (``--tier host``) or the
    three-tier data plane over every rank (``--tier dist-host``, the
    selfless plan: the hottest ``hot_frac`` of the nodes dealt out in
    equal runs)."""
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.ops.heat import get_node_heat
    from dist_gnn_tpu_torch.sampler import layer_capacities
    from dist_gnn_tpu_torch.utils.timing import device_sync

    graph = hg.to_device(dev)
    feats = arrays["features"]
    labels = np.asarray(arrays["labels"], dtype=np.int32)
    N = meta["num_nodes"]
    C_total = max(1, int(N * args.hot_frac))
    _, f_heat = get_node_heat(graph, arrays["train_idx"], list(fan_out))
    order = np.argsort(-f_heat.cpu().numpy())  # hottest first
    frontier_cap = layer_capacities(args.batch_size, fan_out)[-1]
    miss_budget = args.miss_budget or frontier_cap

    if args.tier == "host":
        from dist_gnn_tpu_torch.host_tier import HostCSCStore, HostFeatureStore
        from dist_gnn_tpu_torch.training.pipeline import HostTierTrainer

        hot = order[:C_total].astype(np.int32)
        store = HostFeatureStore(feats, hot, miss_budget=miss_budget, device=dev)
        gstore = HostCSCStore(hg, hot, miss_budget=miss_budget, device=dev) if args.host_struct else None
        trainer = HostTierTrainer(model=model, fan_out=fan_out, store=store, gstore=gstore, dedup_last=False,
                                  device=dev)
        world_batch = args.batch_size
    else:
        from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
        from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore

        n = mesh.size
        C = max(1, C_total // n)
        hot = order[: n * C].reshape(n, C).astype(np.int32)  # selfless plan
        store = DistHostFeatureStore(feats, mesh, hot, miss_budget=miss_budget)
        gstore = DistHostCSCStore(hg, mesh, hot, miss_budget=miss_budget) if args.host_struct else None
        trainer = DistHostTrainer(model=model, fan_out=fan_out, store=store, gstore=gstore, dedup_last=False)
        world_batch = max(n, args.batch_size // n * n)

    say(f"tier={args.tier}: base {feats.nbytes / 2**20:.0f} MiB host-resident, "
        f"hot {C_total} rows in HBM, miss budget {miss_budget}")
    gen = SeedGenerator(arrays["train_idx"], world_batch, shuffle=True, drop_last=True, device="cpu")
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        batches = [(s.numpy(), m.numpy()) for s, m in gen.epoch(torch.Generator().manual_seed(1000 + epoch))]
        ms = trainer.train_batches(graph, labels, batches, epoch)
        device_sync(list(model.parameters()))
        dt = time.perf_counter() - t0
        loss = float(torch.stack([m["loss"] for m in ms]).mean()) if ms else float("nan")
        acc = float(torch.stack([m["acc"] for m in ms]).mean()) if ms else float("nan")
        miss = int(np.mean([m["feat_miss"] for m in ms])) if ms else 0
        ovf = sum(int(m["feat_overflow"]) for m in ms)
        say(f"epoch {epoch}: loss={loss:.4f} train_acc={acc:.4f} miss/batch={miss} overflow={ovf} time={dt:.2f}s")
        log.log("epoch", epoch=epoch, loss=loss, train_acc=acc, feat_miss=miss, feat_overflow=ovf, time_s=dt)
        epochs.append({"epoch": epoch, "loss": loss, "train_acc": acc, "val_acc": None, "time_s": dt,
                       "steps": len(ms), "feat_miss": miss, "feat_overflow": ovf})
    return {"epochs": epochs, "profile": None, "test_acc": None, "step": None}


def _profile(args, trainer, graph, features, labels_t, train_gen, fan_out, dev, log, say) -> Dict[str, float]:
    """The reference's phase split, each phase timed alone by the slope of
    ``measure_chain``; the model and its optimizer are restored after, so
    the phases' extra steps leave the trained model as it was."""
    from dist_gnn_tpu_torch.ops.gather import gather_rows
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.utils.timing import measure_chain

    seeds0, mask0 = next(train_gen.epoch(torch.Generator().manual_seed(77)))
    saved = copy.deepcopy(trainer.model.state_dict()), copy.deepcopy(trainer.optimizer.state_dict())
    sgen = torch.Generator(device=dev).manual_seed(0)

    def phase_sample(c):
        b, _ = sample_blocks(graph, seeds0, mask0, fan_out, args.replace, sgen)
        return (c[0] + 1, b[-1].frontier)

    t_sample = measure_chain(phase_sample, (0, None))
    blocks0, _ = sample_blocks(graph, seeds0, mask0, fan_out, args.replace,
                               torch.Generator(device=dev).manual_seed(0))
    inp = blocks0[-1]
    safe = torch.where(inp.frontier_mask, inp.frontier, 0)

    def phase_load(c):
        return (c[0], torch.where(inp.frontier_mask[:, None], gather_rows(features, safe), 0))

    t_load = measure_chain(phase_load, (0, None))
    tkey = torch.Generator(device=dev).manual_seed(1)

    def phase_train(c):
        return (trainer.train_step(graph, features, labels_t, seeds0, mask0, tkey)["loss"],)

    t_full = measure_chain(phase_train, (None,))
    trainer.model.load_state_dict(saved[0])
    trainer.optimizer.load_state_dict(saved[1])
    resid = max(t_full - t_sample - t_load, 0.0)
    say(f"profile: Sampling {t_sample*1e3:.2f} ms | Loading {t_load*1e3:.2f} ms | "
        f"Training(resid) {resid*1e3:.2f} ms | Iteration {t_full*1e3:.2f} ms (whole step)")
    log.log("profile", sampling_ms=t_sample * 1e3, loading_ms=t_load * 1e3, iteration_ms=t_full * 1e3)
    return {"sampling_ms": t_sample * 1e3, "loading_ms": t_load * 1e3, "training_resid_ms": resid * 1e3,
            "iteration_ms": t_full * 1e3}


def run(args, mesh=None) -> Dict[str, Any]:
    """The whole app in this process: on one device, or as one rank of a
    ``--dist`` / ``--tier dist-host`` world (``mesh``, this rank's
    ``parallel.mesh.Mesh``)."""
    from dist_gnn_tpu_torch.models import GAT, GCN, SAGE, GraphTransformer
    from dist_gnn_tpu_torch.utils.device import resolve_device
    from dist_gnn_tpu_torch.utils.metrics import MetricsLogger

    dev = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank0 = mesh is None or mesh.rank == 0
    say = _printer(rank0)
    fan_out = tuple(int(x) for x in args.fan_out.split(","))
    caps = tuple(int(x) for x in args.frontier_caps.split(",")) if args.frontier_caps else None
    log = MetricsLogger(path=args.metrics_log if rank0 else None, stdout=False)
    try:
        arrays, meta, hg = load_data(args)
        say(f"dataset={meta['name']} nodes={meta['num_nodes']} edges={meta['num_edges']} "
            f"feat={meta['feature_dim']} classes={meta['num_classes']} "
            f"devices={mesh.size if mesh is not None else 1} dist={args.dist}")
        model_cls = {"sage": SAGE, "gat": GAT, "gcn": GCN, "transformer": GraphTransformer}[args.model]
        model = model_cls(meta["feature_dim"], args.hidden, meta["num_classes"], len(fan_out),
                          compute_dtype=torch.bfloat16 if args.bf16 else None,
                          generator=torch.Generator().manual_seed(args.seed), device=dev)
        if args.tier != "hbm":
            res = run_host_tier(args, arrays, meta, hg, model, fan_out, log, dev, mesh, say)
        else:
            res = _run_hbm(args, arrays, hg, model, fan_out, caps, log, dev, mesh, say)
    finally:
        log.close()
    res.update(world=mesh.size if mesh is not None else 1, device=str(dev),
               param_devices=sorted({str(p.device) for p in model.parameters()}))
    return res


def _run_hbm(args, arrays, hg, model, fan_out, caps, log, dev, mesh, say) -> Dict[str, Any]:
    """The device-resident tier: graph and features on the device (one
    device), or node-range sharded over every rank (``--dist``)."""
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.training import Trainer
    from dist_gnn_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from dist_gnn_tpu_torch.utils.timing import device_sync

    feat_dtype = torch.bfloat16 if args.bf16 else torch.float32
    labels_np = np.asarray(arrays["labels"], dtype=np.int32)
    multi_step_fn = None
    batch = args.batch_size
    if args.dist:
        from dist_gnn_tpu_torch.parallel import DistTrainer, ShardedFeatureStore
        from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph

        n = mesh.size
        sg = ShardedGraph.build(hg, mesh)
        store = ShardedFeatureStore(torch.from_numpy(np.array(arrays["features"])).to(feat_dtype), mesh)
        labels_sh = store.shard_of(torch.from_numpy(labels_np)[:, None])
        trainer = DistTrainer(model=model, fan_out=fan_out, store=store, sgraph=sg, replace=args.replace)
        batch = max(n, batch // n * n)  # round the global batch to the world
        step_fn = lambda s, m, key: trainer.train_step(None, labels_sh, s, m, key)  # noqa: E731
        eval_fn = lambda s, m, key: trainer.eval_step(None, None, labels_sh, s, m, key)  # noqa: E731
        graph = features = labels_t = None
    else:
        graph = hg.to_device(dev, with_alias=args.bias)
        features = torch.from_numpy(np.array(arrays["features"])).to(dev, feat_dtype)
        labels_t = torch.from_numpy(labels_np).to(dev)
        if args.autotune:
            from dist_gnn_tpu_torch.cache.autotune import tune_sampler_for

            cfg = tune_sampler_for(hg, arrays["train_idx"], args.batch_size, fan_out)
            say(f"autotuned sampler config: {cfg}")
            caps = cfg.frontier_caps
        trainer = Trainer(model=model, fan_out=fan_out, replace=args.replace, frontier_caps=caps, device=dev)
        step_fn = lambda s, m, key: trainer.train_step(graph, features, labels_t, s, m, key)  # noqa: E731
        if args.unroll > 1:
            multi_step_fn = lambda sU, mU, key: trainer.train_step_multi(  # noqa: E731
                graph, features, labels_t, sU, mU, key)
        eval_fn = lambda s, m, key: trainer.eval_step(None, graph, features, labels_t, s, m, key)  # noqa: E731

    step = 0
    if args.resume:
        step = load_checkpoint(args.resume, model, trainer.optimizer)
        say(f"resumed from {args.resume} at step {step}")

    train_gen = SeedGenerator(arrays["train_idx"], batch, shuffle=True, device=dev)
    valid_gen = SeedGenerator(arrays["valid_idx"], batch, device=dev)
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        key = torch.Generator(device=dev).manual_seed(epoch)
        losses, accs, pending, steps = [], [], [], 0
        for seeds, mask in train_gen.epoch(torch.Generator().manual_seed(1000 + epoch)):
            if multi_step_fn is not None:
                pending.append((seeds, mask))
                if len(pending) < args.unroll:
                    continue
                metrics = multi_step_fn(torch.stack([s for s, _ in pending]),
                                        torch.stack([m for _, m in pending]), key)
                steps += len(pending)
                pending = []
            else:
                metrics = step_fn(seeds, mask, key)
                steps += 1
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
        for seeds, mask in pending:  # the leftover batches of a partial unroll group
            metrics = step_fn(seeds, mask, key)
            steps += 1
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
        device_sync(list(model.parameters()))
        dt = time.perf_counter() - t0
        step += steps
        loss = float(torch.stack(losses).mean())
        acc = float(torch.stack(accs).mean())

        ekey = torch.Generator(device=dev).manual_seed(3)
        correct = total = 0
        for seeds, mask in valid_gen.epoch():
            c, t = eval_fn(seeds, mask, ekey)
            correct, total = correct + c, total + t
        val_acc = int(correct) / max(int(total), 1)
        say(f"epoch {epoch}: loss={loss:.4f} train_acc={acc:.4f} val_acc={val_acc:.4f} time={dt:.2f}s")
        log.log("epoch", epoch=epoch, loss=loss, train_acc=acc, time_s=dt)
        epochs.append({"epoch": epoch, "loss": loss, "train_acc": acc, "val_acc": val_acc, "time_s": dt,
                       "steps": steps})
        if args.checkpoint and (mesh is None or mesh.rank == 0):
            save_checkpoint(args.checkpoint, model, trainer.optimizer, step)

    prof = None
    if args.profile and not args.dist:
        prof = _profile(args, trainer, graph, features, labels_t, train_gen, fan_out, dev, log, say)

    test_acc = None
    if args.full_eval:
        feats32 = torch.from_numpy(np.array(arrays["features"], dtype=np.float32))
        if args.dist:
            from dist_gnn_tpu_torch.parallel.inference_dist import dist_full_graph_inference

            logits = dist_full_graph_inference(model, None, hg, feats32, mesh)
        else:
            from dist_gnn_tpu_torch.models.inference import full_graph_inference

            logits = full_graph_inference(model, None, hg, feats32, device=dev)
        pred = torch.argmax(logits, dim=-1).cpu().numpy()
        test = np.asarray(arrays["test_idx"])
        test_acc = float((pred[test] == labels_np[test]).mean())
        say(f"full-graph test accuracy: {test_acc:.4f}")
        log.log("full_eval", test_acc=test_acc)
    return {"epochs": epochs, "profile": prof, "test_acc": test_acc, "step": step}


def rank_main(mesh, args_dict: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of a ``--dist`` / ``--tier dist-host`` world."""
    return run(argparse.Namespace(**args_dict), mesh)


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    """Parse ``argv`` (default: the command line) and run the app; returns
    rank 0's results (see the module doc)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.full_eval and args.model == "transformer":
        parser.error("--full-eval: the transformer family has no full-graph pass yet; its evaluation is sampled")
    if not (args.dist or args.tier == "dist-host"):
        return run(args)
    from dist_gnn_tpu_torch.examples.graphsage import node_classification as app  # importable by the ranks
    from dist_gnn_tpu_torch.parallel.mesh import launch
    from dist_gnn_tpu_torch.utils.device import resolve_device

    device = "cpu" if args.cpu else str(resolve_device(None))
    world = 2 if args.cpu else torch.cuda.device_count()
    return launch(app.rank_main, world, args=(vars(args),), device=device, timeout_s=RUN_TIMEOUT_S)[0]


if __name__ == "__main__":
    main()
