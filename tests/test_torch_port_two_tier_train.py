"""Training, the host-resident tiers, the ring inference and the flagship
dryrun on the two-tier ``('host', 'data')`` mesh against the JAX
package's, world 4 as ``(2, 2)``.

The JAX side runs in this process on ``make_mesh(4, ("host", "data"),
hosts=2)``; the port's in one spawned world of four gloo ranks, built as
``(2, 2)`` (``launch(..., hosts=2)``), every case in that one world.  Both
see the same numpy inputs and start from the same params; each port rank
gets the keys JAX derives on its chip, whose flat index on the tuple axis
is the rank: ``split(fold_in(fold_in(key, step), rank))`` in
``DistTrainer`` (``test_torch_port_trainer_dist.py``), and in
``DistHostTrainer`` the keys of ``test_torch_port_host_dist.py``.

Tolerances as there: step-1 loss 1e-5, gradients rtol 1e-4 / atol 1e-6
(summation order only), later losses 1e-4, params after 3 Adam steps atol
5e-3, dropout 0.5; staged rows, assembled rows and every count exact; the
ring inference against the single-device one rtol 1e-4 / atol 1e-5.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dist_gnn_tpu.dataloading.preprocess import make_synthetic_dataset
from dist_gnn_tpu.graph import INVALID_ID, HostGraph as JHostGraph
from dist_gnn_tpu.models.gcn import GCN as JGCN
from dist_gnn_tpu.models.inference import full_graph_inference as jfull_graph_inference
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.parallel import DistTrainer as JDistTrainer
from dist_gnn_tpu.parallel import feature_store as jfs
from dist_gnn_tpu.parallel.graph_dist import ShardedGraph as JShardedGraph
from dist_gnn_tpu.parallel.host_dist import DistHostFeatureStore as JDistHostFeatureStore
from dist_gnn_tpu.parallel.host_dist import DistHostTrainer as JDistHostTrainer
from dist_gnn_tpu.parallel.host_struct import DistHostCSCStore as JDistHostCSCStore
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu.training.trainer import TrainState
from dist_gnn_tpu_torch import entry
from dist_gnn_tpu_torch.graph import HostGraph as THostGraph
from dist_gnn_tpu_torch.models import GCN as TGCN
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.models.inference import full_graph_inference
from dist_gnn_tpu_torch.parallel import feature_store as tfs
from dist_gnn_tpu_torch.parallel import mesh as tmesh
from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph as TShardedGraph
from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore
from dist_gnn_tpu_torch.parallel.inference_dist import dist_full_graph_inference
from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer as TDistTrainer
from dist_gnn_tpu_torch.sampler import layer_capacities
from dist_gnn_tpu_torch.weights import gcn_params_from_jax, sage_params_from_jax

torch.set_num_threads(1)
INVALID = int(INVALID_ID)
WORLD, H, D = 4, 2, 2
AX = ("host", "data")
N, F = 600, 8
FAN_OUT = (3, 3)
B = 16  # seeds per rank
STEPS = 3
KEY = 5
SLACK = 4.0  # DistTrainer.sampler_budget_slack and DistHostTrainer.peer_budget_slack, both packages
FEAT_BUDGET = 64
STRUCT_BUDGET = 64  # >= every hop's seeds: no hop re-plans, JAX's staged width is the budget
DEG_CAP = 6  # below the graph's largest degrees: hub rows are presampled


def _data():
    return make_synthetic_dataset(num_nodes=N, avg_degree=6, feature_dim=F, num_classes=3, train_frac=0.5, seed=7)


def _batches(arrays, n=STEPS, pool="train_idx", seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(n):
        s = rng.choice(arrays[pool], WORLD * B, replace=False).astype(np.int32)
        m = np.ones(WORLD * B, bool)
        if step == 1:
            m[2 * B - 3 : 2 * B] = False  # padded seeds on rank 1
            s[~m] = INVALID
        out.append((s, m))
    return out


def _selfless(seed, C):
    return np.random.default_rng(seed).permutation(N)[: WORLD * C].reshape(WORLD, C).astype(np.int32)


def _np_keys(x):
    return np.asarray(x).astype(np.int64)


def _sizes():
    return layer_capacities(B, FAN_OUT)[: len(FAN_OUT)]


def _hub_seed(key):
    return int(np.uint32(np.asarray(jax.random.key_data(key)).ravel()[-1]))


# ---- DistTrainer: configs and keys -----------------------------------------------

# name -> (kind, sharded structure with hot rows, store options)
CONFIGS = {
    "sage_sharded_hot_peer": ("sage", True, {"hot": True, "peer_hot": True}),
    "gcn_replicated_quantized": ("gcn", False, {"quantize": True}),
}


def _jax_model(kind):
    return JSAGE(F, 16, 3, 2) if kind == "sage" else JGCN(F, 16, 3, 2)


def _port_model(kind, params_np):
    if kind == "sage":
        m, conv = TSAGE(F, 16, 3, 2, device="cpu"), sage_params_from_jax
    else:
        m, conv = TGCN(F, 16, 3, 2, device="cpu"), gcn_params_from_jax
    m.load_state_dict(conv(params_np))
    return m


def _hop_keys(k_sample, r, sharded, hot):
    hk = jax.random.split(k_sample, len(FAN_OUT))
    keys = []
    for i, size in enumerate(_sizes()):
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


def _drop_row_keys(rng):
    drop, sizes = [], _sizes()
    for layer in range(len(FAN_OUT) - 1):  # every hidden layer, input-first
        rng, sub = jax.random.split(rng)
        drop.append(_np_keys(jprng.random_keys(sub, (sizes[len(FAN_OUT) - 1 - layer],))))
    return drop


def _step_keys(key, step, r, sharded, hot):
    k_sample, k_drop = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), r))
    return _hop_keys(k_sample, r, sharded, hot), _drop_row_keys(k_drop)


def _hot_ids(seed=3, C=80):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(N, C, replace=False).astype(np.int32) for _ in range(WORLD)])


# ---- DistHostTrainer: keys --------------------------------------------------------


def _device_hop_keys(k_i, r):
    hk = jax.random.split(jax.random.fold_in(k_i, r), len(FAN_OUT))
    return [_np_keys(jprng.random_keys(hk[h], (size,))) for h, size in enumerate(_sizes())]


def _struct_hop_keys(k_i, r):
    hk = jax.random.split(k_i, len(FAN_OUT))
    out = []
    for h, size in enumerate(_sizes()):
        kk = jax.random.fold_in(hk[h], r)
        out.append((_np_keys(jprng.random_keys(kk, (size,))),
                    _np_keys(jprng.random_keys(jax.random.fold_in(kk, 1), (STRUCT_BUDGET,)))))
    return out


def _host_train_keys(key, r, host_struct):
    out = []
    for i in range(STEPS):
        k_i = jax.random.fold_in(key, i)
        hop = _struct_hop_keys(k_i, r) if host_struct else _device_hop_keys(k_i, r)
        drop = _drop_row_keys(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(k_i, 1), i), r))
        out.append((hop, drop))
    return out


# ---- the port's cases --------------------------------------------------------------


def _t(k):
    if isinstance(k, (tuple, list)):
        return type(k)(_t(x) for x in k)
    return torch.from_numpy(k)


def _port_setup(mesh, arrays, cfg, params_np):
    kind, sharded, opts = cfg
    store = tfs.ShardedFeatureStore(arrays["features"], mesh, axis_name=AX, hierarchical=True,
                                    hot_ids=_hot_ids() if opts.get("hot") else None,
                                    peer_hot=opts.get("peer_hot", False), quantize=opts.get("quantize", False))
    thg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    sgraph = TShardedGraph.build(thg, mesh, axis_name=AX, hot_ids=_hot_ids(5)) if sharded else None
    tr = TDistTrainer(model=_port_model(kind, params_np), fan_out=FAN_OUT, store=store, sgraph=sgraph,
                      dedup_last=kind == "sage")
    labels = store.shard_of(arrays["labels"].astype(np.int32)[:, None])
    return tr, None if sharded else thg.to_device("cpu"), labels


def _case_train(mesh, arrays, cfg, params_np, batches, keys):
    tr, graph, labels = _port_setup(mesh, arrays, cfg, params_np)
    assert tr.axis_name == AX
    mets, grads = [], None
    mesh.reset_counts()
    for step, (s, m) in enumerate(batches):
        met = tr.train_step(graph, labels, torch.from_numpy(s), torch.from_numpy(m), _t(keys[mesh.rank][step]))
        mets.append({k: float(v) for k, v in met.items()})
        if step == 0:
            grads = {n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}
    return mets, grads, params, mesh.all_counts()


def _case_eval(mesh, arrays, cfg, params_np, seeds, mask, keys):
    tr, graph, labels = _port_setup(mesh, arrays, cfg, params_np)
    c, t = tr.eval_step(None, graph, labels, torch.from_numpy(seeds), torch.from_numpy(mask), _t(keys[mesh.rank]))
    return int(c), int(t)


def _case_multi(mesh, arrays, cfg, params_np, batches):
    out = []
    for multi in (False, True):
        tr, graph, labels = _port_setup(mesh, arrays, cfg, params_np)
        gen = torch.Generator().manual_seed(10 + mesh.rank)
        seeds = torch.from_numpy(np.stack([s for s, _ in batches]))
        masks = torch.from_numpy(np.stack([m for _, m in batches]))
        if multi:
            met = tr.train_step_multi(graph, labels, seeds, masks, gen)
        else:
            for u in range(seeds.shape[0]):
                met = tr.train_step(graph, labels, seeds[u], masks[u], gen)
        out.append(({k: float(v) for k, v in met.items()},
                    {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}))
    return out


def _case_stage_assemble(mesh, feats, hot, ids, mask, budgets):
    out = {}
    r = mesh.rank
    for budget in budgets:
        st = DistHostFeatureStore(feats, mesh, hot, miss_budget=budget, axis_name=AX)
        staged = st.stage(ids[r], mask[r])
        mesh.reset_counts()
        rows, dropped = st.assemble_local(torch.from_numpy(ids[r]), torch.from_numpy(mask[r]), staged,
                                          budget=ids.shape[1])
        out[budget] = dict(count=staged.count, overflow=staged.overflow, rows=staged.rows.numpy().copy(),
                           slots=staged.slots.numpy().copy(), assembled=rows.numpy().copy(),
                           peer_dropped=int(dropped), counts=mesh.all_counts(), num_hosts=st.num_hosts,
                           peer_size=st.peer_size, union_hit_rate=st.union_hit_rate(ids.reshape(-1)))
    return out


def _case_plan_hop(mesh, arrays, plan, seeds, mask, k, budget, rng_seed):
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    gs = DistHostCSCStore(hg, mesh, plan, miss_budget=budget, deg_cap=DEG_CAP, axis_name=AX)
    local, staged = gs.plan_hop(seeds[mesh.rank], mask[mesh.rank], k, np.random.default_rng(rng_seed))
    return dict(count=staged.count, overflow=staged.overflow, remote=staged.remote, local=local,
                num_hosts=gs.num_hosts, peer_size=gs.peer_size, rows_per_part=gs.rows_per_part)


def _case_hit_rate(mesh, arrays, plan, seeds):
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    gs = DistHostCSCStore(hg, mesh, plan, miss_budget=8, axis_name=AX)
    mine = seeds[mesh.rank]
    return gs.hit_rate(mine), float(np.mean(np.isin(mine, plan[mesh.rank])))


def _port_host_trainer(mesh, arrays, params_np, host_struct, fplan, splan):
    model = TSAGE(F, 16, 3, len(FAN_OUT), device="cpu")
    model.load_state_dict(sage_params_from_jax(params_np))
    store = DistHostFeatureStore(arrays["features"], mesh, fplan, miss_budget=FEAT_BUDGET, axis_name=AX)
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    gstore = DistHostCSCStore(hg, mesh, splan, miss_budget=STRUCT_BUDGET, deg_cap=DEG_CAP,
                              axis_name=AX) if host_struct else None
    tr = DistHostTrainer(model=model, fan_out=FAN_OUT, store=store, gstore=gstore, dedup_last=False,
                         peer_budget_slack=SLACK)
    return tr, None if host_struct else hg.to_device("cpu")


def _case_host_train(mesh, arrays, params_np, host_struct, fplan, splan, batches, seed, keys):
    tr, graph = _port_host_trainer(mesh, arrays, params_np, host_struct, fplan, splan)
    grads = {}

    def record(*args, _orig=tr.compute_step):
        out = _orig(*args)
        if not grads:
            grads.update({n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()})
        return out

    tr.compute_step = record
    mesh.reset_counts()
    mets = tr.train_batches(graph, arrays["labels"], batches, seed, keys=_t(keys[mesh.rank]))
    mets = [{k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in m.items()} for m in mets]
    return mets, grads, {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}, mesh.all_counts()


def _case_infer(mesh, params_np, g):
    ip, ix, feats = g
    model = TSAGE(feats.shape[1], 4, 3, 2, device="cpu")
    model.load_state_dict(sage_params_from_jax(params_np))
    mesh.reset_counts()
    out = dist_full_graph_inference(model, None, THostGraph(indptr=ip, indices=ix), feats, mesh, edge_chunk=128)
    return out.numpy(), dict(mesh.counts)


def _case_dryrun(mesh):
    return entry.dryrun_rank(mesh)


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


# ---- inputs and the world --------------------------------------------------------------


def _assembly_inputs():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    hot = rng.permutation(N)[: WORLD * 40].reshape(WORLD, 40).astype(np.int32)
    ids = rng.integers(0, N, (WORLD, 64)).astype(np.int32)
    mask = rng.random((WORLD, 64)) < 0.9
    ids[~mask] = INVALID
    return feats, hot, ids, mask


BUDGETS = (0, 16, 128)
HOP_K, HOP_BUDGET, HOP_RNG = 4, 8, 5


def _hop_inputs(arrays):
    rng = np.random.default_rng(4)
    plan = _selfless(4, 60)
    seeds = rng.integers(0, N, (WORLD, 32)).astype(np.int32)
    mask = np.ones((WORLD, 32), bool)
    mask[0, -2:] = False
    seeds[~mask] = INVALID
    return plan, seeds, mask


def _ring_graph(N_=261, E=2000, F_=5, seed=3):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N_ - 7, E)
    src = rng.integers(0, N_, E)
    hg = JHostGraph.from_coo(src.astype(np.int32), dst.astype(np.int32), N_)
    return np.asarray(hg.indptr), np.asarray(hg.indices), rng.standard_normal((N_, F_)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    arrays, meta = _data()
    batches = _batches(arrays)
    key = jax.random.key(KEY)
    params = {kind: _jax_model(kind).init(jax.random.key(0)) for kind in ("sage", "gcn")}
    params_np = {k: jax.tree.map(np.asarray, v) for k, v in params.items()}
    hparams = JSAGE(F, 16, 3, len(FAN_OUT)).init(jax.random.key(1))
    hparams_np = jax.tree.map(np.asarray, hparams)
    cases = {}
    for name, (kind, sharded, opts) in CONFIGS.items():
        keys = [[_step_keys(key, s, r, sharded, bool(opts.get("hot"))) for s in range(STEPS)] for r in range(WORLD)]
        cases["train_" + name] = (_case_train, (arrays, CONFIGS[name], params_np[kind], batches, keys))
    eval_seeds = np.asarray(arrays["valid_idx"][np.arange(WORLD * B) % len(arrays["valid_idx"])], np.int32)
    eval_mask = np.ones(WORLD * B, bool)
    ekeys = [_hop_keys(jax.random.fold_in(key, r), r, True, True) for r in range(WORLD)]
    cases["eval"] = (_case_eval, (arrays, CONFIGS["sage_sharded_hot_peer"], params_np["sage"], eval_seeds,
                                  eval_mask, ekeys))
    cases["multi"] = (_case_multi, (arrays, CONFIGS["sage_sharded_hot_peer"], params_np["sage"], batches))
    feats, hot, ids, mask = _assembly_inputs()
    cases["stage_assemble"] = (_case_stage_assemble, (feats, hot, ids, mask, BUDGETS))
    plan, hseeds, hmask = _hop_inputs(arrays)
    cases["plan_hop"] = (_case_plan_hop, (arrays, plan, hseeds, hmask, HOP_K, HOP_BUDGET, HOP_RNG))
    uneven = [hseeds[r][: 8 + 8 * r] for r in range(WORLD)]  # rows of unequal length
    cases["hit_rate"] = (_case_hit_rate, (arrays, plan, uneven))
    fplan, splan = _selfless(5, 40), _selfless(6, 50)
    hseed = _hub_seed(key)
    for hs in (False, True):
        keys = [_host_train_keys(key, r, hs) for r in range(WORLD)]
        cases[f"host_train_{hs}"] = (_case_host_train, (arrays, hparams_np, hs, fplan, splan, batches, hseed, keys))
    g = _ring_graph()
    rparams = JSAGE(g[2].shape[1], 4, 3, 2, dropout=0.0).init(jax.random.key(2))
    cases["infer"] = (_case_infer, (jax.tree.map(np.asarray, rparams), g))
    cases["dryrun"] = (_case_dryrun, ())
    port = tmesh.launch(_run_cases, WORLD, args=(cases,), device="cpu", timeout_s=300, hosts=H)
    return dict(arrays=arrays, batches=batches, key=key, params=params, hparams=hparams, eval=(eval_seeds, eval_mask),
                assembly=(feats, hot, ids, mask), hop=(plan, hseeds, hmask), uneven=uneven, plans=(fplan, splan),
                ring=(g, rparams), port=port)


def _ranks(setup, name):
    out = []
    for r in range(WORLD):
        status, payload = setup["port"][r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(WORLD, AX, hosts=H)


def _recording(inner):
    """``inner`` that also keeps the gradient it was given in its state."""
    def init(p):
        return (inner.init(p), jax.tree.map(jnp.zeros_like, p))

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


def _assert_train_matches(mets, grads, final, jmets, jgrads, jparams, keys):
    for step, (tm, jm) in enumerate(zip(mets, jmets)):
        tol = 1e-5 if step == 0 else 1e-4
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=tol, atol=tol, err_msg=f"step {step}")
        assert tm["acc"] == pytest.approx(float(jm["acc"]), abs=1e-6)
        for k in keys:
            if k in jm:
                assert tm[k] == int(jm[k]), (step, k)
    for pname, g in grads.items():
        layer, leaf = pname.split(".")
        np.testing.assert_allclose(g, np.asarray(jgrads[layer][leaf]), rtol=1e-4, atol=1e-6, err_msg=pname)
    for pname, p in final.items():
        layer, leaf = pname.split(".")
        np.testing.assert_allclose(p, np.asarray(jparams[layer][leaf]), atol=5e-3, err_msg=pname)


# ---- DistTrainer ---------------------------------------------------------------------


def _jax_dist_trainer(jmesh, arrays, cfg, params):
    kind, sharded, opts = cfg
    store = jfs.ShardedFeatureStore(arrays["features"], jmesh, axis_name=AX, hierarchical=True,
                                    hot_ids=_hot_ids() if opts.get("hot") else None,
                                    peer_hot=opts.get("peer_hot", False), quantize=opts.get("quantize", False))
    jhg = JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    sgraph = JShardedGraph.build(jhg, jmesh, axis_name=AX, hot_ids=_hot_ids(5)) if sharded else None
    tr = JDistTrainer(model=_jax_model(kind), fan_out=FAN_OUT, store=store, sgraph=sgraph,
                      dedup_last=kind == "sage", sampler_budget_slack=SLACK)
    tr.optimizer = _recording(tr.optimizer)
    lab = np.zeros((store.shard_size * WORLD, 1), np.int32)
    lab[:N, 0] = arrays["labels"]
    labels = jax.device_put(lab, NamedSharding(jmesh, P(AX, None)))
    state = TrainState(params=params, opt_state=tr.optimizer.init(params), step=jnp.zeros((), jnp.int32))
    return tr, sgraph.shard_args() if sharded else jhg.to_device(), labels, state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dist_train_step_on_the_tuple_axis_matches_jax(setup, jmesh, name):
    cfg = CONFIGS[name]
    tr, graph, labels, state = _jax_dist_trainer(jmesh, setup["arrays"], cfg, setup["params"][cfg[0]])
    jmets, jgrads = [], None
    for step, (s, m) in enumerate(setup["batches"]):
        state, met = tr.train_step(state, graph, labels, jnp.asarray(s), jnp.asarray(m), setup["key"])
        jmets.append(met)
        if step == 0:
            jgrads = state.opt_state[1]
    res = _ranks(setup, "train_" + name)
    for mets, grads, final, counts in res:
        _assert_train_matches(mets, grads, final, jmets, jgrads, state.params,
                              ("overflow", "sampler_overflow", "frontier_overflow"))
        assert all(m["overflow"] == m["sampler_overflow"] == m["frontier_overflow"] == 0 for m in mets)
        # the features ride both stages; the labels, the sampler and the sums the world
        assert counts["host"]["all_to_all"] >= 2 * STEPS and counts["data"]["all_to_all"] >= 2 * STEPS
        assert counts["world"]["all_to_all"] >= 2 * STEPS and counts["world"]["all_reduce"] >= 3 * STEPS
    for pname in res[0][2]:  # every rank holds the same params
        for r in range(1, WORLD):
            np.testing.assert_array_equal(res[0][2][pname], res[r][2][pname])


def test_dist_eval_step_on_the_tuple_axis_matches_jax(setup, jmesh):
    tr, graph, labels, state = _jax_dist_trainer(jmesh, setup["arrays"], CONFIGS["sage_sharded_hot_peer"],
                                                 setup["params"]["sage"])
    seeds, mask = setup["eval"]
    c, t = tr.eval_step(state.params, graph, labels, jnp.asarray(seeds), jnp.asarray(mask), setup["key"])
    for got in _ranks(setup, "eval"):
        assert got == (int(c), int(t))
    assert int(t) == WORLD * B


def test_dist_train_step_multi_equals_sequential_steps(setup):
    for (m_seq, p_seq), (m_multi, p_multi) in _ranks(setup, "multi"):
        assert m_seq["loss"] == m_multi["loss"] and m_seq["acc"] == m_multi["acc"]
        for k in p_seq:
            np.testing.assert_array_equal(p_seq[k], p_multi[k])


# ---- the host-resident tiers ---------------------------------------------------------------


@pytest.mark.parametrize("budget", BUDGETS)
def test_stage_on_the_tuple_axis_equals_jax_chip_rows(setup, jmesh, budget):
    """Each rank stages JAX's chip row: the rows hot on no rank of its
    host, so rows hot only on the other host are staged."""
    feats, hot, ids, mask = setup["assembly"]
    js = JDistHostFeatureStore(feats, jmesh, hot, miss_budget=budget, axis_name=AX)
    assert js.num_hosts == H and js.peer_size == D
    staged = js.stage(ids, mask)
    jrows, jslots = np.asarray(staged.rows), np.asarray(staged.slots)
    got = [res[budget] for res in _ranks(setup, "stage_assemble")]
    cross = 0
    for r, g in enumerate(got):
        m = g["count"]
        np.testing.assert_array_equal(g["slots"], jslots[r][:m])
        np.testing.assert_array_equal(g["rows"], jrows[r][:m])
        assert (jslots[r][m:] == ids.shape[1]).all()
        assert g["overflow"] == max(0, m - budget) and (g["num_hosts"], g["peer_size"]) == (H, D)
        h = r // D
        host_hot = np.isin(ids[r], hot[h * D : (h + 1) * D].reshape(-1))
        assert m == int((mask[r] & ~host_hot).sum())
        cross += int((mask[r] & np.isin(ids[r], hot.reshape(-1)) & ~host_hot).sum())
        assert g["union_hit_rate"] == js.union_hit_rate(ids.reshape(-1), chip=r)
    assert sum(g["count"] for g in got) == staged.count >= cross > 0
    assert sum(g["overflow"] for g in got) == staged.overflow


def test_three_tier_assembly_on_the_tuple_axis_exact_and_equal_to_jax(setup, jmesh):
    """JAX's ``tests/test_host_dist.py:316-370`` on (2, 2): local, peer-hot
    (the other rank of the host) and staged rows exact and equal to JAX's
    ``assemble_local``, ``peer_dropped`` 0, the peer round on the data
    sub-mesh."""
    feats, hot, ids, mask = setup["assembly"]
    st = JDistHostFeatureStore(feats, jmesh, hot, miss_budget=16, axis_name=AX)
    staged = st.stage(ids, mask)
    L = ids.shape[1]

    def body(args, ids_, m_, srows, sslots):
        rows, dropped = st.assemble_local(args, ids_, m_, srows, sslots, L)
        return rows, jax.lax.psum(dropped, AX)

    jrows, jdropped = jax.jit(jax.shard_map(
        body, mesh=jmesh,
        in_specs=(st.shard_specs(), P(AX), P(AX), P(AX, None, None), P(AX, None)),
        out_specs=(P(AX), P()), check_vma=False,
    ))(st.shard_args(), jnp.asarray(ids.reshape(-1)), jnp.asarray(mask.reshape(-1)), staged.rows, staged.slots)
    jrows = np.asarray(jrows).reshape(WORLD, L, F)
    assert int(jdropped) == 0
    for r, res in enumerate(_ranks(setup, "stage_assemble")):
        g = res[16]
        oracle = np.where(mask[r][:, None], feats[np.where(mask[r], ids[r], 0)], 0)
        np.testing.assert_array_equal(g["assembled"], oracle)
        np.testing.assert_array_equal(g["assembled"], jrows[r])
        assert g["peer_dropped"] == 0
        peer = r ^ 1  # the other rank of this host
        assert (mask[r] & np.isin(ids[r], hot[peer]) & ~np.isin(ids[r], hot[r])).any()
        c = g["counts"]
        assert c["data"]["all_to_all"] == 2 and c["data"]["host_syncs"] == 1
        assert c["host"]["all_to_all"] == c["world"]["all_to_all"] == c["world"]["host_syncs"] == 0


def test_plan_hop_on_the_tuple_axis_counts_struct_remote_as_jax(setup, jmesh):
    """Per-host node ranges: the staged rows from the other host's range
    (``struct_remote``), the staged and over-budget rows and the hot-row
    probe equal JAX's over the [4, L] seed matrix."""
    arrays = setup["arrays"]
    plan, seeds, mask = setup["hop"]
    gs = JDistHostCSCStore(JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"]), jmesh, plan,
                           miss_budget=HOP_BUDGET, deg_cap=DEG_CAP, axis_name=AX)
    local, _, stats = gs.plan_hop(seeds, mask, HOP_K, np.random.default_rng(HOP_RNG))
    got = _ranks(setup, "plan_hop")
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["local"], np.asarray(local)[r])
        assert (g["num_hosts"], g["peer_size"], g["rows_per_part"]) == (gs.num_hosts, gs.peer_size,
                                                                         gs.rows_per_part) == (H, D, N // H)
    assert sum(g["count"] for g in got) == stats["struct_miss"]
    assert sum(g["overflow"] for g in got) == stats["struct_overflow"]
    assert sum(g["remote"] for g in got) == stats["struct_remote"] > 0


def test_dist_host_csc_hit_rate_is_over_every_rank_s_seeds(setup, jmesh):
    """``hit_rate`` sums every rank's hits and seeds, as JAX's over its
    seed matrix: with rows of unequal length (8, 16, 24, 32 seeds) it
    differs from the mean of the ranks' own rates."""
    arrays = setup["arrays"]
    plan = setup["hop"][0]
    gs = JDistHostCSCStore(JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"]), jmesh, plan,
                           miss_budget=8, axis_name=AX)
    want = gs.hit_rate(setup["uneven"])
    got = _ranks(setup, "hit_rate")
    assert all(g == pytest.approx(want, abs=1e-15) for g, _ in got)
    assert abs(np.mean([own for _, own in got]) - want) > 1e-3


@pytest.mark.parametrize("host_struct", [False, True], ids=["device_structure", "host_structure"])
def test_dist_host_trainer_on_the_tuple_axis_matches_jax(setup, jmesh, host_struct):
    arrays = setup["arrays"]
    fplan, splan = setup["plans"]
    store = JDistHostFeatureStore(arrays["features"], jmesh, fplan, miss_budget=FEAT_BUDGET, axis_name=AX)
    jhg = JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    gstore = JDistHostCSCStore(jhg, jmesh, splan, miss_budget=STRUCT_BUDGET, deg_cap=DEG_CAP,
                               axis_name=AX) if host_struct else None
    tr = JDistHostTrainer(model=JSAGE(F, 16, 3, len(FAN_OUT)), fan_out=FAN_OUT, store=store, gstore=gstore,
                          dedup_last=False, peer_budget_slack=SLACK)
    tr.optimizer = _recording(tr.optimizer)
    params = setup["hparams"]
    state = TrainState(params=params, opt_state=tr.optimizer.init(params), step=jnp.zeros((), jnp.int32))
    grads = []
    orig = tr.compute_phase

    def record(state, *args):
        new_state, m = orig(state, *args)
        if not grads:
            grads.append(new_state.opt_state[1])
        return new_state, m

    tr.compute_phase = record
    state, jmets = tr.train_batches(state, None if host_struct else jhg.to_device(), arrays["labels"],
                                    setup["batches"], setup["key"])
    res = _ranks(setup, f"host_train_{host_struct}")
    for mets, g, final, counts in res:
        assert len(mets) == STEPS
        _assert_train_matches(mets, g, final, jmets, grads[0], state.params,
                              ("peer_dropped", "feat_miss", "feat_overflow", "struct_miss", "struct_overflow",
                               "struct_remote", "sampler_overflow"))
        assert all(m["peer_dropped"] == 0 for m in mets) and any(m["feat_miss"] > 0 for m in mets)
        if host_struct:
            assert any(m["struct_remote"] > 0 for m in mets)
        assert counts["data"]["host_syncs"] >= STEPS and counts["host"]["all_to_all"] == 0
    for pname in res[0][2]:
        for r in range(1, WORLD):
            np.testing.assert_array_equal(res[0][2][pname], res[r][2][pname])


# ---- the ring inference and the flagship dryrun ------------------------------------------


def test_ring_inference_on_a_two_axis_mesh_equals_single_device(setup):
    (ip, ix, feats), rparams = setup["ring"]
    model = TSAGE(feats.shape[1], 4, 3, 2, device="cpu")
    model.load_state_dict(sage_params_from_jax(jax.tree.map(np.asarray, rparams)))
    want = full_graph_inference(model, None, THostGraph(indptr=ip, indices=ix), torch.from_numpy(feats),
                                edge_chunk=64, device="cpu").numpy()
    want_jax = np.asarray(jfull_graph_inference(JSAGE(feats.shape[1], 4, 3, 2, dropout=0.0), rparams,
                                                JHostGraph(indptr=ip, indices=ix), jnp.asarray(feats),
                                                node_chunk=64, edge_chunk=128))
    for got, counts in _ranks(setup, "infer"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-5)
        assert counts["p2p"] == 2 * (WORLD - 1) and counts["all_gather"] == 1  # the ring spans the world


def test_dryrun_multichip_body_on_the_two_tier_mesh(setup):
    res = _ranks(setup, "dryrun")
    for m in res:
        assert m["mesh"] == {"host": H, "data": D}
        for k in ("loss", "acc", "biased_q_loss", "gat_loss", "dist_host_loss"):
            assert np.isfinite(m[k]), k
        assert m["overflow"] == m["sampler_overflow"] == m["biased_overflow"] == m["peer_dropped"] == 0
        assert m["feat_miss"] > 0 and m["struct_miss"] > 0
    for k in ("loss", "biased_q_loss", "gat_loss", "dist_host_loss"):  # summed over the world: equal on every rank
        assert len({m[k] for m in res}) == 1, k
    assert entry.summary_line(WORLD, res[0]).startswith("dryrun_multichip(4): ok — mesh={'host': 2, 'data': 2}")
