"""``DistTrainer`` against the JAX package's, world 2, and the distributed
gradient against the single-device one.

The JAX side runs in this process on ``make_mesh(2)``; the port's in one
spawned world of two gloo ranks, every case in that one world.  Both
start from the same params (``weights.*_params_from_jax``) and see the
same global batches; each port rank gets the keys JAX derives on its chip:
``k_sample, k_drop = split(fold_in(fold_in(key, step), rank))``, the
per-hop sampler keys from ``k_sample`` (on a sharded graph the hot tier's
and the owner table's, ``graph_dist`` module doc) and the per-layer
dropout row keys from ``k_drop``.  JAX's trainer runs with an optimizer
that records the gradient it is given (the sum over the chips) beside
its Adam state, so the step's gradient can be compared.  Tolerances as
for the single-device trainer (``test_torch_port_training.py``): step-1
loss 1e-5, gradients rtol 1e-4 / atol 1e-6 (summation order only), later
losses 1e-4, params after 3 Adam steps atol 5e-3 (a gradient element near
0 may take the other sign).  Dropout is on (0.5).
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from dist_gnn_tpu.dataloading.preprocess import make_synthetic_dataset
from dist_gnn_tpu.graph import INVALID_ID, HostGraph as JHostGraph
from dist_gnn_tpu.models.gat import GAT as JGAT
from dist_gnn_tpu.models.gcn import GCN as JGCN
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.parallel import DistTrainer as JDistTrainer
from dist_gnn_tpu.parallel import feature_store as jfs
from dist_gnn_tpu.parallel.graph_dist import ShardedGraph as JShardedGraph
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu.training.trainer import TrainState
from dist_gnn_tpu_torch.graph import HostGraph as THostGraph
from dist_gnn_tpu_torch.models import GAT as TGAT
from dist_gnn_tpu_torch.models import GCN as TGCN
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.parallel import feature_store as tfs
from dist_gnn_tpu_torch.parallel import mesh as tmesh
from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph as TShardedGraph
from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer as TDistTrainer
from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks
from dist_gnn_tpu_torch.training import Trainer as TTrainer
from dist_gnn_tpu_torch.training import dist_masked_nll_loss
from dist_gnn_tpu_torch.weights import gat_params_from_jax, gcn_params_from_jax, sage_params_from_jax

torch.set_num_threads(1)
INVALID = int(INVALID_ID)
WORLD = 2
FAN_OUT = (3, 3)
B = 16  # seeds per rank
STEPS = 3
SLACK = 4.0  # DistTrainer.sampler_budget_slack, both packages


def _data():
    arrays, meta = make_synthetic_dataset(
        num_nodes=600, avg_degree=6, feature_dim=8, num_classes=3, train_frac=0.5, seed=7
    )
    return arrays, meta


def _batches(arrays):
    rng = np.random.default_rng(0)
    out = []
    for step in range(STEPS):
        s = rng.choice(arrays["train_idx"], WORLD * B, replace=False).astype(np.int32)
        m = np.ones(WORLD * B, bool)
        if step == 1:
            m[B - 3 : B] = False  # padded seeds on rank 0
            s[~m] = INVALID
        out.append((s, m))
    return out


# configs: name -> (kind, sharded structure, store options, dedup_last)
CONFIGS = {
    "sage_replicated": ("sage", False, {}, False),
    "gat_replicated": ("gat", False, {}, True),
    "gcn_replicated": ("gcn", False, {}, False),
    "sage_sharded_hot_peer": ("sage", True, {"hot": True, "peer_hot": True}, False),
    "gat_sharded": ("gat", True, {}, True),
    "gcn_sharded_quantized": ("gcn", True, {"quantize": True}, False),
}


def _hot_ids(seed=3, C=80):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(600, C, replace=False).astype(np.int32) for _ in range(WORLD)])


def _jax_model(kind, num_classes):
    if kind == "sage":
        return JSAGE(8, 16, num_classes, 2)
    if kind == "gcn":
        return JGCN(8, 16, num_classes, 2)
    return JGAT(8, 8, num_classes, 2, num_heads=2, use_fused=False)


def _port_model(kind, num_classes, params_np):
    if kind == "sage":
        m, conv = TSAGE(8, 16, num_classes, 2, device="cpu"), sage_params_from_jax
    elif kind == "gcn":
        m, conv = TGCN(8, 16, num_classes, 2, device="cpu"), gcn_params_from_jax
    else:
        m, conv = TGAT(8, 8, num_classes, 2, num_heads=2, device="cpu"), gat_params_from_jax
    m.load_state_dict(conv(params_np))
    return m


# ---- keys: what JAX derives on chip r --------------------------------------


def _np_keys(x):
    return np.asarray(x).astype(np.int64)


def _hop_sizes():
    return layer_capacities(B, FAN_OUT)[: len(FAN_OUT)]


def _hop_keys(k_sample, r, sharded, hot):
    sizes = _hop_sizes()
    hk = jax.random.split(k_sample, len(FAN_OUT))
    keys = []
    for i, size in enumerate(sizes):
        if not sharded:
            keys.append(_np_keys(jprng.random_keys(hk[i], (size,))))
            continue
        Pb = jfs.request_budget(size, WORLD, SLACK)
        owner = _np_keys(jprng.random_keys(jax.random.fold_in(hk[i], r), (WORLD * Pb,)))
        if hot:
            hot_key = jax.random.fold_in(jax.random.fold_in(hk[i], 1), r)
            keys.append((_np_keys(jprng.random_keys(hot_key, (size,))), owner))
        else:
            keys.append(owner)
    return keys


def _step_keys(key, step, r, sharded, hot):
    k_sample, k_drop = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), r))
    drop, rng = [], k_drop
    sizes = _hop_sizes()
    for l in range(len(FAN_OUT) - 1):  # every hidden layer, input-first
        rng, sub = jax.random.split(rng)
        drop.append(_np_keys(jprng.random_keys(sub, (sizes[len(FAN_OUT) - 1 - l],))))
    return _hop_keys(k_sample, r, sharded, hot), drop


def _eval_keys(key, r, sharded, hot):
    return _hop_keys(jax.random.fold_in(key, r), r, sharded, hot)


# ---- the port's cases --------------------------------------------------------


def _t(k):
    if isinstance(k, (tuple, list)):
        return type(k)(_t(x) for x in k)
    return torch.from_numpy(k)


def _port_setup(mesh, arrays, meta, cfg, params_np):
    kind, sharded, store_opts, dedup_last = cfg
    hot = _hot_ids() if store_opts.get("hot") else None
    store = tfs.ShardedFeatureStore(arrays["features"], mesh, hot_ids=hot, peer_hot=store_opts.get("peer_hot", False),
                                    quantize=store_opts.get("quantize", False))
    thg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    sgraph = graph = None
    if sharded:
        sgraph = TShardedGraph.build(thg, mesh, hot_ids=_hot_ids(5) if store_opts.get("hot") else None)
    else:
        graph = thg.to_device("cpu")
    model = _port_model(kind, meta["num_classes"], params_np)
    tr = TDistTrainer(model=model, fan_out=FAN_OUT, store=store, sgraph=sgraph, dedup_last=dedup_last)
    labels = store.shard_of(arrays["labels"].astype(np.int32)[:, None])
    return tr, graph, labels


def _case_train(mesh, arrays, meta, cfg, params_np, batches, keys):
    tr, graph, labels = _port_setup(mesh, arrays, meta, cfg, params_np)
    mets, grads = [], None
    for step, (s, m) in enumerate(batches):
        met = tr.train_step(graph, labels, torch.from_numpy(s), torch.from_numpy(m), _t(keys[mesh.rank][step]))
        mets.append({k: float(v) for k, v in met.items()})
        if step == 0:
            grads = {n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}
    return mets, grads, params


def _case_eval(mesh, arrays, meta, cfg, params_np, seeds, mask, keys):
    tr, graph, labels = _port_setup(mesh, arrays, meta, cfg, params_np)
    c, t = tr.eval_step(None, graph, labels, torch.from_numpy(seeds), torch.from_numpy(mask),
                        _t(keys[mesh.rank]))
    return int(c), int(t)


def _case_multi(mesh, arrays, meta, cfg, params_np, batches):
    out = []
    for multi in (False, True):
        tr, graph, labels = _port_setup(mesh, arrays, meta, cfg, params_np)
        gen = torch.Generator().manual_seed(10 + mesh.rank)
        seeds = torch.from_numpy(np.stack([s for s, _ in batches]))
        masks = torch.from_numpy(np.stack([m for _, m in batches]))
        if multi:
            met = tr.train_step_multi(graph, labels, seeds, masks, gen)
        else:
            tot = 0
            for u in range(seeds.shape[0]):
                met = tr.train_step(graph, labels, seeds[u], masks[u], gen)
                tot += int(met["overflow"]) + int(met["sampler_overflow"]) + int(met["frontier_overflow"])
        out.append(({k: float(v) for k, v in met.items()},
                    {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}))
    return out


def _case_grad_protocol(mesh, arrays, meta, params_np):
    """Fixed blocks per rank: the sum over the ranks of the gradients of
    the globally normalised loss (features through the exchange) against
    the single-device gradient of the concatenated batch."""
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"]).to_device("cpu")
    feats = torch.from_numpy(arrays["features"])
    labels = torch.from_numpy(arrays["labels"].astype(np.int32))
    seeds = np.random.default_rng(0).choice(600, WORLD * B, replace=False).astype(np.int32)
    blocks = []
    for c in range(WORLD):
        s = torch.from_numpy(seeds[c * B : (c + 1) * B])
        blk, _ = sample_blocks(hg, s, torch.ones(B, dtype=torch.bool), FAN_OUT, False,
                               torch.Generator().manual_seed(100 + c))
        blocks.append(blk)
    store = tfs.ShardedFeatureStore(arrays["features"], mesh)
    model = _port_model("sage", meta["num_classes"], params_np)
    model.dropout = 0.0
    mine = blocks[mesh.rank]
    rows, _ = store.fetch_local(mine[-1].frontier, mine[-1].frontier_mask, budget=mine[-1].frontier.shape[0])
    lab = labels[torch.from_numpy(seeds[mesh.rank * B : (mesh.rank + 1) * B]).long()]
    loss, _ = dist_masked_nll_loss(model, True, mesh, mine, rows, lab, mine[0].seed_mask, None)
    loss.backward()
    flat = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    loss_d = float(mesh.all_reduce(loss.detach().reshape(1))[0])
    ref = _port_model("sage", meta["num_classes"], params_np)
    ref.dropout = 0.0
    total = 0.0
    for c, blk in enumerate(blocks):
        safe = torch.where(blk[-1].frontier_mask, blk[-1].frontier, 0).long()
        logits = ref(tuple(reversed(blk)), feats[safe])
        lab_c = labels[torch.from_numpy(seeds[c * B : (c + 1) * B]).long()]
        total = total - torch.log_softmax(logits.float(), -1).gather(1, lab_c[:, None].long()).sum()
    total = total / (WORLD * B)
    total.backward()
    return loss_d, flat.numpy(), float(total), torch.cat([p.grad.reshape(-1) for p in ref.parameters()]).numpy()


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


# ---- JAX side ------------------------------------------------------------------


def _recording(inner):
    """``inner`` that also keeps the gradient it was given in its state."""
    def init(p):
        return (inner.init(p), jax.tree.map(jnp.zeros_like, p))

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


def _jax_setup(jmesh, arrays, meta, cfg, params):
    kind, sharded, store_opts, dedup_last = cfg
    hot = _hot_ids() if store_opts.get("hot") else None
    store = jfs.ShardedFeatureStore(arrays["features"], jmesh, hot_ids=hot,
                                    peer_hot=store_opts.get("peer_hot", False),
                                    quantize=store_opts.get("quantize", False))
    jhg = JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    sgraph = JShardedGraph.build(jhg, jmesh, hot_ids=_hot_ids(5) if store_opts.get("hot") else None) if sharded else None
    graph = sgraph.shard_args() if sharded else jhg.to_device()
    tr = JDistTrainer(model=_jax_model(kind, meta["num_classes"]), fan_out=FAN_OUT, store=store, sgraph=sgraph,
                      dedup_last=dedup_last, sampler_budget_slack=SLACK)
    tr.optimizer = _recording(tr.optimizer)
    lab = np.zeros((store.shard_size * WORLD, 1), np.int32)
    lab[: meta["num_nodes"], 0] = arrays["labels"]
    labels = jax.device_put(lab, NamedSharding(jmesh, P("data", None)))
    state = TrainState(params=params, opt_state=tr.optimizer.init(params), step=jnp.zeros((), jnp.int32))
    return tr, graph, labels, state


KEY = 5


@pytest.fixture(scope="module")
def setup():
    """Inputs, JAX's params and every rank's keys; the port's world."""
    arrays, meta = _data()
    batches = _batches(arrays)
    params = {kind: _jax_model(kind, meta["num_classes"]).init(jax.random.key(0)) for kind in ("sage", "gat", "gcn")}
    params_np = {k: jax.tree.map(np.asarray, v) for k, v in params.items()}
    key = jax.random.key(KEY)
    cases = {}
    for name, cfg in CONFIGS.items():
        kind, sharded, store_opts, _ = cfg
        hot = bool(store_opts.get("hot"))
        keys = [[_step_keys(key, step, r, sharded, hot) for step in range(STEPS)] for r in range(WORLD)]
        cases["train_" + name] = (_case_train, (arrays, meta, cfg, params_np[kind], batches, keys))
    eval_seeds = np.asarray(arrays["valid_idx"][np.arange(WORLD * B) % len(arrays["valid_idx"])], np.int32)
    eval_mask = np.ones(WORLD * B, bool)
    for name in ("sage_replicated", "sage_sharded_hot_peer"):
        cfg = CONFIGS[name]
        keys = [_eval_keys(key, r, cfg[1], bool(cfg[2].get("hot"))) for r in range(WORLD)]
        cases["eval_" + name] = (_case_eval, (arrays, meta, cfg, params_np["sage"], eval_seeds, eval_mask, keys))
    cases["multi"] = (_case_multi, (arrays, meta, CONFIGS["sage_sharded_hot_peer"], params_np["sage"], batches))
    cases["grad_protocol"] = (_case_grad_protocol, (arrays, meta, params_np["sage"]))
    port = tmesh.launch(_run_cases, WORLD, args=(cases,), device="cpu", timeout_s=300)
    return arrays, meta, batches, params, eval_seeds, eval_mask, port


def _ranks(port, name):
    out = []
    for r in range(WORLD):
        status, payload = port[r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(WORLD)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dist_train_step_matches_jax(setup, jmesh, name):
    arrays, meta, batches, params, *_, port = setup
    cfg = CONFIGS[name]
    tr, graph, labels, state = _jax_setup(jmesh, arrays, meta, cfg, params[cfg[0]])
    jmets, jgrads = [], None
    for step, (s, m) in enumerate(batches):
        state, met = tr.train_step(state, graph, labels, jnp.asarray(s), jnp.asarray(m), jax.random.key(KEY))
        jmets.append(met)
        if step == 0:
            jgrads = state.opt_state[1]
    res = _ranks(port, "train_" + name)
    for r, (mets, grads, final) in enumerate(res):
        for step, (tm, jm) in enumerate(zip(mets, jmets)):
            tol = 1e-5 if step == 0 else 1e-4
            np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=tol, atol=tol, err_msg=f"step {step}")
            assert tm["acc"] == pytest.approx(float(jm["acc"]), abs=1e-6)
            for k in ("overflow", "sampler_overflow", "frontier_overflow"):
                assert tm[k] == int(jm[k]) == 0, k
        for pname, g in grads.items():
            layer, leaf = pname.split(".")
            np.testing.assert_allclose(g, np.asarray(jgrads[layer][leaf]), rtol=1e-4, atol=1e-6, err_msg=pname)
        for pname, p in final.items():
            layer, leaf = pname.split(".")
            np.testing.assert_allclose(p, np.asarray(state.params[layer][leaf]), atol=5e-3, err_msg=pname)
    # every rank holds the same params
    for pname in res[0][2]:
        np.testing.assert_array_equal(res[0][2][pname], res[1][2][pname])


@pytest.mark.parametrize("name", ["sage_replicated", "sage_sharded_hot_peer"])
def test_dist_eval_step_matches_jax(setup, jmesh, name):
    arrays, meta, _, params, eval_seeds, eval_mask, port = setup
    tr, graph, labels, state = _jax_setup(jmesh, arrays, meta, CONFIGS[name], params["sage"])
    c, t = tr.eval_step(state.params, graph, labels, jnp.asarray(eval_seeds), jnp.asarray(eval_mask),
                        jax.random.key(KEY))
    for got in _ranks(port, "eval_" + name):
        assert got == (int(c), int(t))
    assert int(t) == WORLD * B


def test_dist_train_step_multi_equals_sequential_steps(setup):
    *_, port = setup
    for (m_seq, p_seq), (m_multi, p_multi) in _ranks(port, "multi"):
        assert m_seq["loss"] == m_multi["loss"] and m_seq["acc"] == m_multi["acc"]
        for k in p_seq:
            np.testing.assert_array_equal(p_seq[k], p_multi[k])
        assert m_multi["overflow"] == m_multi["sampler_overflow"] == m_multi["frontier_overflow"] == 0


def test_dist_gradient_equals_single_device_gradient(setup):
    *_, port = setup
    for loss_d, g_d, loss_ref, g_ref in _ranks(port, "grad_protocol"):
        np.testing.assert_allclose(loss_d, loss_ref, rtol=1e-5)
        np.testing.assert_allclose(g_d, g_ref, rtol=2e-4, atol=1e-6)


def test_world_of_one_equals_trainer(tmp_path):
    """A gloo world of one in this process: DistTrainer's steps equal
    Trainer's on the same generator (the same keys in the same order)."""
    arrays, meta = _data()
    batches = _batches(arrays)
    params = jax.tree.map(np.asarray, _jax_model("sage", meta["num_classes"]).init(jax.random.key(1)))
    graph = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"]).to_device("cpu")
    mesh = tmesh.initialize_distributed("file://" + str(tmp_path / "rendezvous"), 0, 1, device="cpu")
    try:
        assert mesh.backend == "gloo" and mesh.size == 1
        store = tfs.ShardedFeatureStore(arrays["features"], mesh)
        dtr = TDistTrainer(model=_port_model("sage", meta["num_classes"], params), fan_out=FAN_OUT, store=store,
                           dedup_last=False)
        str_ = TTrainer(model=_port_model("sage", meta["num_classes"], params), fan_out=FAN_OUT, dedup_last=False,
                        device="cpu")
        labels = torch.from_numpy(arrays["labels"].astype(np.int32))
        g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
        for s, m in batches:
            s, m = torch.from_numpy(s[:B]), torch.from_numpy(m[:B])
            dm = dtr.train_step(graph, store.shard_of(labels[:, None]), s, m, g1)
            sm = str_.train_step(graph, torch.from_numpy(arrays["features"]), labels, s, m, g2)
            np.testing.assert_allclose(float(dm["loss"]), float(sm["loss"]), rtol=1e-6, atol=1e-7)
            assert float(dm["acc"]) == float(sm["acc"])
        for (n1, p1), (_, p2) in zip(dtr.model.named_parameters(), str_.model.named_parameters()):
            np.testing.assert_allclose(p1.detach().numpy(), p2.detach().numpy(), rtol=1e-6, atol=1e-7, err_msg=n1)
        assert mesh.counts["all_to_all"] == 0 and mesh.counts["host_syncs"] == 0  # a world of one skips the exchange
        assert mesh.counts["all_reduce"] == 3 * len(batches)  # the count, the gradients, the metrics
    finally:
        dist.destroy_process_group()
