"""The distributed host-resident tiers (``parallel/host_dist.py``,
``parallel/host_struct.py``, ``cache/cost_model.calibrate_ici``) against
the JAX package's on ``make_mesh(2)``, world 2.

The JAX side runs in this process; the port's in one spawned world of
two gloo ranks, every case in that one world (``parallel.mesh.launch``).
Both see the same numpy inputs; each port rank gets the keys JAX derives
on its chip: ``fold_in(fold_in(key, batch), rank)`` split per hop for the
device sampler, ``fold_in(split(fold_in(key, batch), hops)[h], rank)`` for
a host-structure hop (its staged rows take the first m of JAX's
``random_keys(fold_in(kk, 1), (M,))``, M JAX's grown width), and
``fold_in(fold_in(fold_in(fold_in(key, batch), 1), step), rank)`` for
dropout.  Hub rows are presampled from ``default_rng(uint32(key_data[-1]))``
on both sides.

Tolerances: assembled rows, staged contents and every count exact;
staged hops bit for bit; the trainer as ``test_torch_port_trainer_dist.py``
holds ``DistTrainer``: step-1 loss 1e-5, gradients rtol 1e-4 / atol 1e-6,
later losses 1e-4, params after 3 Adam steps atol 5e-3, dropout 0.5;
pipelined == sequential 1e-5.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from dist_gnn_tpu.dataloading.preprocess import make_synthetic_dataset
from dist_gnn_tpu.graph import INVALID_ID, HostGraph as JHostGraph
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.parallel.host_dist import DistHostFeatureStore as JDistHostFeatureStore
from dist_gnn_tpu.parallel.host_dist import DistHostTrainer as JDistHostTrainer
from dist_gnn_tpu.parallel.host_struct import DistHostCSCStore as JDistHostCSCStore
from dist_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_gnn_tpu.training.trainer import TrainState
from dist_gnn_tpu_torch.cache.cost_model import calibrate_ici
from dist_gnn_tpu_torch.graph import HostGraph as THostGraph
from dist_gnn_tpu_torch.host_tier import HostCSCStore, HostFeatureStore, sample_staged_hop, slab_width
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.parallel import mesh as tmesh
from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore
from dist_gnn_tpu_torch.sampler import layer_capacities
from dist_gnn_tpu_torch.training.pipeline import HostTierTrainer, batch_keys
from dist_gnn_tpu_torch.weights import sage_params_from_jax

torch.set_num_threads(1)
INVALID = int(INVALID_ID)
WORLD = 2
N, F = 600, 8
FAN_OUT = (3, 3)
B = 16  # seeds per rank
STEPS = 3
KEY = 11
SLACK = 4.0  # DistHostTrainer.peer_budget_slack, both packages
FEAT_BUDGET = 64
STRUCT_BUDGET = 64  # >= every hop's seeds: no hop re-plans, JAX's M is the budget
DEG_CAP = 6  # below the graph's largest degrees: hub rows are presampled


def _data(with_probs=False):
    return make_synthetic_dataset(num_nodes=N, avg_degree=6, feature_dim=F, num_classes=3, train_frac=0.5,
                                  with_probs=with_probs, seed=7)


def _batches(arrays, n=STEPS, pool="train_idx", seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(n):
        s = rng.choice(arrays[pool], WORLD * B, replace=False).astype(np.int32)
        m = np.ones(WORLD * B, bool)
        if step == 1:
            m[B - 3 : B] = False  # padded seeds on rank 0
            s[~m] = INVALID
        out.append((s, m))
    return out


def _plans(seed=3, C=80):
    """(selfless, selfish) [2, C] plans: disjoint halves of the hottest 2C,
    or the hottest C on both ranks."""
    order = np.random.default_rng(seed).permutation(N).astype(np.int32)
    return order[: WORLD * C].reshape(WORLD, C), np.tile(order[:C], (WORLD, 1))


def _np_keys(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _hub_seed(key):
    return int(np.uint32(np.asarray(jax.random.key_data(key)).ravel()[-1]))


# ---- keys: what JAX derives on chip r -----------------------------------------


def _sizes():
    return layer_capacities(B, FAN_OUT)[: len(FAN_OUT)]


def _device_hop_keys(k_i, r):
    hk = jax.random.split(jax.random.fold_in(k_i, r), len(FAN_OUT))
    return [_np_keys(jprng.random_keys(hk[h], (size,))) for h, size in enumerate(_sizes())]


def _struct_hop_keys(k_i, r, widths):
    """Per hop (hot keys, staged keys); ``widths[h]`` is JAX's staged width."""
    hk = jax.random.split(k_i, len(FAN_OUT))
    out = []
    for h, size in enumerate(_sizes()):
        kk = jax.random.fold_in(hk[h], r)
        out.append((_np_keys(jprng.random_keys(kk, (size,))),
                    _np_keys(jprng.random_keys(jax.random.fold_in(kk, 1), (widths[h],)))))
    return out


def _drop_keys(k_i, step, r):
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(k_i, 1), step), r)
    keys, sizes = [], _sizes()
    for layer in range(len(FAN_OUT) - 1):  # every hidden layer, input-first
        rng, sub = jax.random.split(rng)
        keys.append(_np_keys(jprng.random_keys(sub, (sizes[len(FAN_OUT) - 1 - layer],))))
    return keys


def _train_keys(key, r, host_struct):
    out = []
    for i in range(STEPS):
        k_i = jax.random.fold_in(key, i)
        hop = _struct_hop_keys(k_i, r, [STRUCT_BUDGET] * len(FAN_OUT)) if host_struct else _device_hop_keys(k_i, r)
        out.append((hop, _drop_keys(k_i, i, r)))
    return out


def _eval_keys(key, r, host_struct, n):
    out = []
    for i in range(n):
        k_i = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), i)
        out.append(_struct_hop_keys(k_i, r, [STRUCT_BUDGET] * len(FAN_OUT)) if host_struct
                   else _device_hop_keys(k_i, r))
    return out


# ---- the port's cases ------------------------------------------------------------


def _case_stage_assemble(mesh, feats, plans, ids, mask, budgets):
    """Per plan and budget: the staged rows and the assembled frontier."""
    out = {}
    r = mesh.rank
    for pname, plan in plans.items():
        for budget in budgets:
            st = DistHostFeatureStore(feats, mesh, plan, miss_budget=budget)
            staged = st.stage(ids[r], mask[r])
            mesh.reset_counts()
            rows, dropped = st.assemble_local(torch.from_numpy(ids[r]), torch.from_numpy(mask[r]), staged,
                                              budget=len(ids[r]))
            out[(pname, budget)] = dict(
                count=staged.count, overflow=staged.overflow, width=staged.width,
                rows=staged.rows.numpy().copy(), slots=staged.slots.numpy().copy(), assembled=rows.numpy().copy(),
                peer_dropped=int(dropped), union_hit_rate=st.union_hit_rate(ids.reshape(-1)),
                counts=dict(mesh.counts),
            )
    return out


def _case_plan_hop(mesh, arrays, probs, plan, seeds, mask, k, budget, rng_seed, hop_key_np):
    """One hop of DistHostCSCStore on this rank's seeds, sampled on
    injected keys."""
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"], probs=probs)
    gs = DistHostCSCStore(hg, mesh, plan, miss_budget=budget, deg_cap=DEG_CAP)
    r = mesh.rank
    local, staged = gs.plan_hop(seeds[r], mask[r], k, np.random.default_rng(rng_seed))
    nb = sample_staged_hop(gs.hot_graph, torch.from_numpy(local), staged, k, hop_key_np[r])
    ids = torch.where(nb.mask, nb.ids, INVALID_ID)
    return dict(count=staged.count, overflow=staged.overflow, remote=staged.remote, local=local,
                ids=ids.numpy(), mask=nb.mask.numpy(), hit_rate=gs.hit_rate(seeds[r]))


def _port_trainer(mesh, arrays, params_np, host_struct, fplan, splan, dropout=0.5):
    model = TSAGE(F, 16, 3, len(FAN_OUT), dropout=dropout, device="cpu")
    model.load_state_dict(sage_params_from_jax(params_np))
    store = DistHostFeatureStore(arrays["features"], mesh, fplan, miss_budget=FEAT_BUDGET)
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    gstore = DistHostCSCStore(hg, mesh, splan, miss_budget=STRUCT_BUDGET, deg_cap=DEG_CAP) if host_struct else None
    tr = DistHostTrainer(model=model, fan_out=FAN_OUT, store=store, gstore=gstore, dedup_last=False,
                         peer_budget_slack=SLACK)
    return tr, None if host_struct else hg.to_device("cpu")


def _case_train(mesh, arrays, params_np, host_struct, fplan, splan, batches, seed, keys):
    tr, graph = _port_trainer(mesh, arrays, params_np, host_struct, fplan, splan)
    grads = {}

    def record(*args, _orig=tr.compute_step):
        out = _orig(*args)
        if not grads:
            grads.update({n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()})
        return out

    tr.compute_step = record
    mets = tr.train_batches(graph, arrays["labels"], batches, seed, keys=keys[mesh.rank])
    mets = [{k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in m.items()} for m in mets]
    return mets, grads, {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}


def _case_eval(mesh, arrays, params_np, host_struct, fplan, splan, batches, seed, keys):
    tr, graph = _port_trainer(mesh, arrays, params_np, host_struct, fplan, splan)
    return tr.eval_batches(None, graph, arrays["labels"], batches, seed, keys=keys[mesh.rank])


def _case_pipelined(mesh, arrays, params_np, host_struct, fplan, splan, batches):
    """train_batches against a sequential sample -> stage -> compute loop
    on the same generators and hub rng."""
    out = []
    for pipelined in (True, False):
        tr, graph = _port_trainer(mesh, arrays, params_np, host_struct, fplan, splan)
        if pipelined:
            tr.train_batches(graph, arrays["labels"], batches, 21)
        else:
            rng = np.random.default_rng(21)
            for i, (s, m) in enumerate(batches):
                s, m = tr._my_slice(s, m)
                sk, dk = batch_keys(21, i, tr.device, mesh.rank)
                blocks, _, fr, frm = tr.sample(graph, s, m, sk, rng)
                tr.compute_step(blocks, tr.store.stage(fr, frm), tr.batch_labels(arrays["labels"], s, m),
                                torch.from_numpy(m), dk)
        out.append({n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()})
    return out


def _case_calibrate_ici(mesh):
    mesh.reset_counts()
    bw = calibrate_ici(mesh, mbytes=1)
    return bw, dict(mesh.counts)


def _run_cases(mesh, cases):
    out = {}
    for name, (fn, args) in cases.items():
        try:
            out[name] = ("ok", fn(mesh, *args))
        except Exception:  # noqa: BLE001 — reported by the case's own test
            out[name] = ("error", traceback.format_exc())
    return out


# ---- inputs shared by the fixture and the tests ------------------------------------


def _assembly_inputs():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    L = 64
    ids = rng.integers(0, N, (WORLD, L)).astype(np.int32)
    mask = rng.random((WORLD, L)) < 0.9
    ids[~mask] = INVALID
    selfless, selfish = _plans()
    return feats, {"selfless": selfless, "selfish": selfish}, ids, mask


BUDGETS = (0, 1, 16, 64)


def _hop_inputs(weighted):
    """Seeds that rank 0 mostly caches and rank 1 mostly does not, so only
    rank 1 re-plans past the budget."""
    arrays, _ = _data(with_probs=weighted)
    rng = np.random.default_rng(4)
    order = rng.permutation(N).astype(np.int32)
    plan = order[:160].reshape(WORLD, 80)
    L = 32
    s0 = np.concatenate([rng.choice(plan[0], L - 4, replace=False), rng.choice(order[160:], 4, replace=False)])
    s1 = rng.choice(order[160:], L, replace=False)
    seeds = np.stack([s0, s1]).astype(np.int32)
    mask = np.ones((WORLD, L), bool)
    mask[0, -2:] = False
    seeds[~mask] = INVALID
    return arrays, plan, seeds, mask


HOP_K, HOP_BUDGET, HOP_RNG = 4, 8, 5


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(WORLD)


def _jax_hop(jmesh, weighted):
    """JAX's plan and staged hop on the [2, L] seeds: (stats, per-chip
    ids and mask, its staged width, its key)."""
    arrays, plan, seeds, mask = _hop_inputs(weighted)
    jhg = JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"],
                     probs=arrays["probs"] if weighted else None)
    gs = JDistHostCSCStore(jhg, jmesh, plan, miss_budget=HOP_BUDGET, deg_cap=DEG_CAP)
    fstore = JDistHostFeatureStore(arrays["features"], jmesh, plan, miss_budget=64)
    tr = JDistHostTrainer(model=JSAGE(F, 16, 3, 1), fan_out=(HOP_K,), store=fstore, gstore=gs, dedup_last=False)
    local, staged, stats = gs.plan_hop(seeds, mask, HOP_K, np.random.default_rng(HOP_RNG))
    key = jax.random.key(31 + weighted)
    blk = tr._hop_phase(gs.shard_args(), tr._put_batch(seeds.reshape(-1)), tr._put_batch(mask.reshape(-1)),
                        local, staged, k=HOP_K, last=True, key=key)
    L = seeds.shape[1]
    fr = np.asarray(blk["frontier"]).reshape(WORLD, -1)
    fm = np.asarray(blk["frontier_mask"]).reshape(WORLD, -1)
    ids = fr[:, L:].reshape(WORLD, HOP_K, L).transpose(0, 2, 1)
    msk = fm[:, L:].reshape(WORLD, HOP_K, L).transpose(0, 2, 1)
    return dict(stats=stats, ids=ids, mask=msk, local=np.asarray(local), width=staged["row_of"].shape[-1],
                hit_rate=gs.hit_rate(seeds), key=key), (arrays, plan, seeds, mask)


def _hop_keys_np(key, width, weighted):
    out = []
    L = _hop_inputs(weighted)[2].shape[1]
    for r in range(WORLD):
        kk = jax.random.fold_in(key, r)
        if weighted:  # the hot sub-CSC has alias tables: the alias sampler's keys
            hot = (_np_keys(jprng.random_keys(kk, (2, L, 4 * HOP_K))),
                   _np_keys(jprng.random_keys(jax.random.fold_in(kk, 1), (L, 2 * HOP_K))))
        else:
            hot = _np_keys(jprng.random_keys(kk, (L,)))
        out.append((hot, _np_keys(jprng.random_keys(jax.random.fold_in(kk, 1), (width,)))))
    return out


def _recording(inner):
    """``inner`` that also keeps the gradient it was given in its state."""
    def init(p):
        return (inner.init(p), jax.tree.map(jnp.zeros_like, p))

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


def _jax_trainer(jmesh, arrays, params, host_struct, fplan, splan):
    store = JDistHostFeatureStore(arrays["features"], jmesh, fplan, miss_budget=FEAT_BUDGET)
    jhg = JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    gstore = JDistHostCSCStore(jhg, jmesh, splan, miss_budget=STRUCT_BUDGET, deg_cap=DEG_CAP) if host_struct else None
    tr = JDistHostTrainer(model=JSAGE(F, 16, 3, len(FAN_OUT)), fan_out=FAN_OUT, store=store, gstore=gstore,
                          dedup_last=False, peer_budget_slack=SLACK)
    tr.optimizer = _recording(tr.optimizer)
    state = TrainState(params=params, opt_state=tr.optimizer.init(params), step=jnp.zeros((), jnp.int32))
    return tr, None if host_struct else jhg.to_device(), state


@pytest.fixture(scope="module")
def setup(jmesh):
    """The inputs, JAX's hop results and every rank's keys; the port's world."""
    arrays, _ = _data()
    batches = _batches(arrays)
    eval_b = _batches(arrays, n=2, pool="test_idx", seed=1)
    params = JSAGE(F, 16, 3, len(FAN_OUT)).init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    fplan, _ = _plans(seed=5)
    splan, _ = _plans(seed=6, C=100)
    key = jax.random.key(KEY)
    seed = _hub_seed(key)
    feats, plans, ids, mask = _assembly_inputs()
    cases = {"stage_assemble": (_case_stage_assemble, (feats, plans, ids, mask, BUDGETS))}
    hops = {}
    for weighted in (False, True):
        want, (harr, hplan, hseeds, hmask) = _jax_hop(jmesh, weighted)
        hops[weighted] = want
        cases[f"hop_{weighted}"] = (_case_plan_hop, (
            harr, harr["probs"] if weighted else None, hplan, hseeds, hmask, HOP_K, HOP_BUDGET, HOP_RNG,
            _hop_keys_np(want["key"], want["width"], weighted)))
    for hs in (False, True):
        keys = [_train_keys(key, r, hs) for r in range(WORLD)]
        cases[f"train_{hs}"] = (_case_train, (arrays, params_np, hs, fplan, splan, batches, seed, keys))
        ekeys = [_eval_keys(key, r, hs, len(eval_b)) for r in range(WORLD)]
        cases[f"eval_{hs}"] = (_case_eval, (arrays, params_np, hs, fplan, splan, eval_b, seed, ekeys))
    cases["pipelined"] = (_case_pipelined, (arrays, params_np, True, fplan, splan, batches))
    cases["calibrate_ici"] = (_case_calibrate_ici, ())
    port = tmesh.launch(_run_cases, WORLD, args=(cases,), device="cpu", timeout_s=300)
    return dict(arrays=arrays, batches=batches, eval_b=eval_b, params=params, fplan=fplan, splan=splan, key=key,
                hops=hops, assembly=(feats, plans, ids, mask), port=port)


def _ranks(setup, name):
    out = []
    for r in range(WORLD):
        status, payload = setup["port"][r][name]
        if status != "ok":
            pytest.fail(f"rank {r} of case {name} failed:\n{payload}")
        out.append(payload)
    return out


# ---- features: stage and the three-tier assembly -----------------------------------


@pytest.mark.parametrize("plan", ["selfless", "selfish"])
@pytest.mark.parametrize("budget", BUDGETS)
def test_stage_equals_jax_chip_rows(setup, jmesh, plan, budget):
    """Each rank stages JAX's chip row (the rows hot on no chip), grown
    past budgets of 0 and 1 alike; counts and overflows as JAX's."""
    feats, plans, ids, mask = setup["assembly"]
    js = JDistHostFeatureStore(feats, jmesh, plans[plan], miss_budget=budget).stage(ids, mask)
    jrows, jslots = np.asarray(js.rows), np.asarray(js.slots)
    L = ids.shape[1]
    got = [res[(plan, budget)] for res in _ranks(setup, "stage_assemble")]
    for r, g in enumerate(got):
        m = g["count"]
        np.testing.assert_array_equal(g["slots"], jslots[r][:m])
        np.testing.assert_array_equal(g["rows"], jrows[r][:m])
        assert (jslots[r][m:] == L).all() and not jrows[r][m:].any()
        assert g["overflow"] == max(0, m - budget)
        assert g["width"] == slab_width(budget, m, L)
        hot_somewhere = np.isin(ids[r], plans[plan])
        assert m == int((mask[r] & ~hot_somewhere).sum())
    assert sum(g["count"] for g in got) == js.count
    assert sum(g["overflow"] for g in got) == js.overflow
    assert max(g["width"] for g in got) == jrows.shape[1]


@pytest.mark.parametrize("plan", ["selfless", "selfish"])
def test_three_tier_assembly_exact_and_equal_to_jax(setup, jmesh, plan):
    """Local, peer-hot and staged rows exact, equal to JAX's
    ``assemble_local``; ``peer_dropped`` 0; peer-hot rows fetched in one
    round from the other rank."""
    feats, plans, ids, mask = setup["assembly"]
    st = JDistHostFeatureStore(feats, jmesh, plans[plan], miss_budget=16)
    staged = st.stage(ids, mask)
    L = ids.shape[1]

    def body(args, ids_, m_, srows, sslots):
        rows, dropped = st.assemble_local(args, ids_, m_, srows, sslots, L)
        return rows, jax.lax.psum(dropped, "data")

    jrows, jdropped = jax.jit(jax.shard_map(
        body, mesh=jmesh,
        in_specs=(st.shard_specs(), P("data"), P("data"), P("data", None, None), P("data", None)),
        out_specs=(P("data"), P()), check_vma=False,
    ))(st.shard_args(), jnp.asarray(ids.reshape(-1)), jnp.asarray(mask.reshape(-1)), staged.rows, staged.slots)
    jrows = np.asarray(jrows).reshape(WORLD, L, F)
    assert int(jdropped) == 0
    for r, res in enumerate(_ranks(setup, "stage_assemble")):
        g = res[(plan, 16)]
        oracle = np.where(mask[r][:, None], feats[np.where(mask[r], ids[r], 0)], 0)
        np.testing.assert_array_equal(g["assembled"], oracle)
        np.testing.assert_array_equal(g["assembled"], jrows[r])
        assert g["peer_dropped"] == 0
        peer = mask[r] & np.isin(ids[r], plans[plan][1 - r]) & ~np.isin(ids[r], plans[plan][r])
        if plan == "selfless":
            assert peer.any()  # rows served by the other rank
        assert g["counts"]["all_to_all"] == 2 and g["counts"]["host_syncs"] == 1


def test_selfless_stages_fewer_rows_than_selfish(setup, jmesh):
    feats, plans, ids, mask = setup["assembly"]
    res = _ranks(setup, "stage_assemble")
    staged = {p: sum(r[(p, 64)]["count"] for r in res) for p in plans}
    assert staged["selfless"] < staged["selfish"]
    for p, plan in plans.items():
        assert staged[p] == JDistHostFeatureStore(feats, jmesh, plan, miss_budget=64).stage(ids, mask).count


@pytest.mark.parametrize("plan", ["selfless", "selfish"])
def test_union_hit_rate_equals_jax(setup, jmesh, plan):
    feats, plans, ids, mask = setup["assembly"]
    want = JDistHostFeatureStore(feats, jmesh, plans[plan], miss_budget=8).union_hit_rate(ids.reshape(-1))
    for res in _ranks(setup, "stage_assemble"):
        assert res[(plan, 64)]["union_hit_rate"] == want
        assert res[("selfless", 64)]["union_hit_rate"] > res[("selfish", 64)]["union_hit_rate"]


# ---- structure: plan_hop and the staged hop ----------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "weighted"])
def test_plan_hop_and_staged_hop_bit_for_bit(setup, weighted):
    """Each rank's hop equals JAX's chip row bit for bit (hot rows, staged
    rows, hub rows presampled from the forked rng); the stats sum to JAX's;
    rank 1 re-plans past the budget (its staged width is JAX's grown
    width) while rank 0 does not."""
    want = setup["hops"][weighted]
    got = _ranks(setup, f"hop_{weighted}")
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["local"], want["local"][r])
        np.testing.assert_array_equal(g["mask"], want["mask"][r])
        np.testing.assert_array_equal(g["ids"], want["ids"][r])
        assert g["mask"].any()
    st = want["stats"]
    assert sum(g["count"] for g in got) == st["struct_miss"]
    assert sum(g["overflow"] for g in got) == st["struct_overflow"]
    assert sum(g["remote"] for g in got) == st["struct_remote"]
    assert got[0]["count"] <= HOP_BUDGET < got[1]["count"]
    assert want["width"] > HOP_BUDGET and got[1]["overflow"] == got[1]["count"] - HOP_BUDGET > 0
    assert np.mean([g["hit_rate"] for g in got]) == pytest.approx(want["hit_rate"], abs=1e-12)


# ---- the trainer -------------------------------------------------------------------------------


@pytest.mark.parametrize("host_struct", [False, True], ids=["device_structure", "host_structure"])
def test_dist_host_trainer_matches_jax(setup, jmesh, host_struct):
    tr, graph, state = _jax_trainer(jmesh, setup["arrays"], setup["params"], host_struct, setup["fplan"],
                                    setup["splan"])
    grads = []
    orig = tr.compute_phase

    def record(state, *args):
        new_state, m = orig(state, *args)
        if not grads:
            grads.append(new_state.opt_state[1])
        return new_state, m

    tr.compute_phase = record
    state, jmets = tr.train_batches(state, graph, setup["arrays"]["labels"], setup["batches"], setup["key"])
    res = _ranks(setup, f"train_{host_struct}")
    for r, (mets, g, final) in enumerate(res):
        assert len(mets) == STEPS
        for step, (tm, jm) in enumerate(zip(mets, jmets)):
            tol = 1e-5 if step == 0 else 1e-4
            np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=tol, atol=tol, err_msg=f"step {step}")
            assert tm["acc"] == pytest.approx(float(jm["acc"]), abs=1e-6)
            assert tm["peer_dropped"] == int(jm["peer_dropped"]) == 0
            for k in ("feat_miss", "feat_overflow", "struct_miss", "struct_overflow", "struct_remote",
                      "sampler_overflow"):
                if k in jm:
                    assert tm[k] == int(jm[k]), (step, k)
            assert tm["sample_ms"] > 0 and tm["stage_ms"] > 0 and tm["stage_h2d_ms"] is None
        assert any(tm["feat_miss"] > 0 for tm in mets)
        if host_struct:
            assert any(tm["struct_miss"] > 0 for tm in mets) and any(tm["struct_remote"] > 0 for tm in mets)
        for pname, gv in g.items():
            layer, leaf = pname.split(".")
            np.testing.assert_allclose(gv, np.asarray(grads[0][layer][leaf]), rtol=1e-4, atol=1e-6, err_msg=pname)
        for pname, p in final.items():
            layer, leaf = pname.split(".")
            np.testing.assert_allclose(p, np.asarray(state.params[layer][leaf]), atol=5e-3, err_msg=pname)
    for pname in res[0][2]:  # every rank holds the same params
        np.testing.assert_array_equal(res[0][2][pname], res[1][2][pname])


@pytest.mark.parametrize("host_struct", [False, True], ids=["device_structure", "host_structure"])
def test_eval_batches_matches_jax(setup, jmesh, host_struct):
    tr, graph, state = _jax_trainer(jmesh, setup["arrays"], setup["params"], host_struct, setup["fplan"],
                                    setup["splan"])
    want = tr.eval_batches(state.params, graph, setup["arrays"]["labels"], setup["eval_b"], setup["key"])
    for got in _ranks(setup, f"eval_{host_struct}"):
        assert tuple(got) == tuple(want)
    assert want[1] == sum(int(m.sum()) for _, m in setup["eval_b"])


def test_pipelined_train_batches_equals_sequential(setup):
    for p_pipe, p_seq in _ranks(setup, "pipelined"):
        for k in p_pipe:
            np.testing.assert_allclose(p_pipe[k], p_seq[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_calibrate_ici_at_world_two(setup):
    for bw, counts in _ranks(setup, "calibrate_ici"):
        assert np.isfinite(bw) and bw > 0
        assert counts["all_to_all"] == 2 + 3 * (3 + 12)  # measure_chain: warm-up, 3 reps of 3 and of 12


# ---- a world of one, in this process ------------------------------------------------


@pytest.mark.parametrize("host_struct", [False, True], ids=["device_structure", "host_structure"])
def test_world_of_one_equals_host_tier_trainer(tmp_path, host_struct):
    """A gloo world of one: DistHostTrainer's batches equal
    HostTierTrainer's on the same seed and hot sets (hub rows off: the
    distributed plan forks its hub rng per rank), with no exchange round
    and no host sync; calibrate_ici returns the cost model's figure."""
    arrays, _ = _data()
    params = jax.tree.map(np.asarray, JSAGE(F, 16, 3, len(FAN_OUT)).init(jax.random.key(1)))
    batches = [(s[:B], m[:B]) for s, m in _batches(arrays)]
    fplan, splan = _plans(seed=8)[0][:1], _plans(seed=9, C=150)[0][:1]
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    deg_cap = int(np.diff(arrays["indptr"]).max())
    mesh = tmesh.initialize_distributed("file://" + str(tmp_path / "rendezvous"), 0, 1, device="cpu")
    try:
        runs = []
        for dist_run in (True, False):
            model = TSAGE(F, 16, 3, len(FAN_OUT), device="cpu")
            model.load_state_dict(sage_params_from_jax(params))
            if dist_run:
                store = DistHostFeatureStore(arrays["features"], mesh, fplan, miss_budget=32)
                gstore = DistHostCSCStore(hg, mesh, splan, 64, deg_cap=deg_cap) if host_struct else None
                tr = DistHostTrainer(model=model, fan_out=FAN_OUT, store=store, gstore=gstore, dedup_last=False)
            else:
                store = HostFeatureStore(arrays["features"], fplan[0], 32, device="cpu")
                gstore = HostCSCStore(hg, splan[0], 64, deg_cap=deg_cap, device="cpu") if host_struct else None
                tr = HostTierTrainer(model=model, fan_out=FAN_OUT, store=store, gstore=gstore, dedup_last=False,
                                     device="cpu")
            mesh.reset_counts()
            mets = tr.train_batches(None if host_struct else hg.to_device("cpu"), arrays["labels"], batches, 4)
            runs.append(([float(m["loss"]) for m in mets], [m["feat_miss"] for m in mets],
                         {n: p.detach().numpy() for n, p in model.named_parameters()}, dict(mesh.counts)))
        (dl, dmiss, dp, counts), (sl, smiss, sp, _) = runs
        np.testing.assert_allclose(dl, sl, rtol=1e-6, atol=1e-7)
        assert dmiss == smiss and all(m > 0 for m in dmiss)
        for n in dp:
            np.testing.assert_allclose(dp[n], sp[n], rtol=1e-6, atol=1e-7, err_msg=n)
        assert counts["all_to_all"] == 0 and counts["host_syncs"] == 0
        assert counts["all_reduce"] == 3 * len(batches) + 1  # count, gradients, metrics; the host stats once
        assert calibrate_ici(mesh) == 45e9
    finally:
        dist.destroy_process_group()


def test_refusals():
    """replace=True with host structure and an integer hot dtype raise, as
    in the JAX package (``host_dist.py:118-125, :327-333``); the two-tier
    axis builds on the mesh (1, 1) with JAX's ``num_hosts`` and
    ``peer_size``."""
    arrays, _ = _data()
    mesh = tmesh.Mesh(rank=0, size=1, device=torch.device("cpu"))
    plan = _plans()[0][:1]
    hg = THostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    two = tmesh.Mesh(rank=0, size=1, device=torch.device("cpu"), shape=(1, 1))
    jtwo = jmake_mesh(1, ("host", "data"), hosts=1)
    hs = DistHostFeatureStore(arrays["features"], two, plan, 8, axis_name=("host", "data"))
    # JAX's sets these from its mesh, then cannot shard a one-host union table over 'host'
    assert hs.hierarchical and (hs.num_hosts, hs.peer_size) == (jtwo.shape["host"], jtwo.shape["data"]) == (1, 1)
    gs = DistHostCSCStore(hg, two, plan, 8, axis_name=("host", "data"))
    jgs = JDistHostCSCStore(JHostGraph(indptr=arrays["indptr"], indices=arrays["indices"]), jtwo, plan, 8,
                            axis_name=("host", "data"))
    assert (gs.num_hosts, gs.peer_size, gs.rows_per_part) == (jgs.num_hosts, jgs.peer_size, jgs.rows_per_part)
    with pytest.raises(ValueError):
        DistHostFeatureStore(arrays["features"], mesh, plan, 8, hot_dtype=torch.int8)
    with pytest.raises(ValueError):
        DistHostFeatureStore(arrays["features"], mesh, np.zeros((2, 4), np.int32), 8)
    store = DistHostFeatureStore(arrays["features"], mesh, plan, 8)
    gstore = DistHostCSCStore(hg, mesh, plan, 8)
    model = TSAGE(F, 16, 3, 2, device="cpu")
    with pytest.raises(NotImplementedError):
        DistHostTrainer(model=model, fan_out=FAN_OUT, store=store, gstore=gstore, replace=True)
    DistHostTrainer(model=model, fan_out=FAN_OUT, store=store, replace=True)
