"""The rails: the frontier-cap tuner (``cache/autotune.py``), phase timing and
metrics (``utils/metrics.py``) and checkpoints (``training/checkpoint.py``)
against the JAX package's, on the CPU; and how ``utils/timing.profile_device``
chooses among profiler sessions that lost records.

Tolerances: the caps and the simulation exact (the same numpy draws);
checkpoints exact (bit for bit, dtypes and shapes included); the profiler
totals to float rounding (pytest.approx).
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dist_gnn_tpu.cache import autotune as jautotune
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.training import checkpoint as jcheckpoint
from dist_gnn_tpu_torch.cache import autotune as tautotune
from dist_gnn_tpu_torch.graph import HostGraph
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.sampler import layer_capacities
from dist_gnn_tpu_torch.training import Trainer, make_optimizer
from dist_gnn_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from dist_gnn_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graph():
    arrays, _ = jpre.make_synthetic_dataset(num_nodes=3000, avg_degree=8, train_frac=0.3, seed=2)
    return arrays


# ---- the frontier-cap tuner ------------------------------------------------------


@pytest.mark.parametrize(
    "batch,fan_out,seed,cap_slack",
    [(64, (5, 3), 0, 1.05), (128, (10, 5, 3), 1, 1.05), (32, (4, 4, 4), 3, 1.3), (500, (2,), 2, 1.05)],
)
def test_tune_sampler_caps_equal_jax(graph, batch, fan_out, seed, cap_slack):
    args = (graph["indptr"], graph["indices"], graph["train_idx"], batch, fan_out)
    want = jautotune.tune_sampler(*args, seed=seed, cap_slack=cap_slack)
    got = tautotune.tune_sampler(*args, seed=seed, cap_slack=cap_slack)
    assert got.frontier_caps == want.frontier_caps
    # caps lie between the seeds and the padded worst case; the last hop is never capped
    pads = layer_capacities(batch, fan_out)[1:]
    assert all(batch <= c <= p for c, p in zip(got.frontier_caps[:-1], pads))
    assert got.frontier_caps[-1] == 10**9
    hg = HostGraph(indptr=graph["indptr"], indices=graph["indices"])
    assert tautotune.tune_sampler_for(hg, graph["train_idx"], batch, fan_out, seed=seed,
                                      cap_slack=cap_slack) == got


@pytest.mark.parametrize("batch,fan_out,trials,seed", [(50, (4, 3), 3, 7), (40, (6, 4, 2), 2, 1)])
def test_simulate_hops_equals_jax(graph, batch, fan_out, trials, seed):
    """The frontier sizes seen per hop and the per-trial trails (every
    hop's seeds, the last hop's frontier slots) equal the JAX function's
    first and third outputs (the port does not return its second)."""
    args = (graph["indptr"], graph["indices"], graph["train_idx"], batch, fan_out, trials, seed)
    jc, _, jt = jautotune._simulate_hops(*args)
    caps, trails = tautotune._simulate_hops(*args)
    assert caps == jc
    assert len(trails) == len(jt) == trials
    for (seeds, front), (jseeds, jfront) in zip(trails, jt):
        assert len(seeds) == len(jseeds) == len(fan_out)
        for s, js in zip(seeds, jseeds):
            np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(front, jfront)
    assert tautotune._round_up(1025, 512) == jautotune._round_up(1025, 512) == 1536


def test_tuned_caps_train_without_frontier_overflow(graph):
    """A Trainer under the tuned caps: smaller frontiers than the padded
    worst case, and (for batches like the simulated ones) none dropped."""
    fan_out, batch = (5, 3), 64
    cfg = tautotune.tune_sampler(graph["indptr"], graph["indices"], graph["train_idx"], batch, fan_out)
    g = HostGraph(indptr=graph["indptr"], indices=graph["indices"]).to_device("cpu")
    tr = Trainer(model=TSAGE(64, 16, 16, 2, device="cpu"), fan_out=fan_out, device="cpu",
                 frontier_caps=cfg.frontier_caps)
    feats, labels = torch.from_numpy(graph["features"]), torch.from_numpy(graph["labels"])
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        seeds = torch.from_numpy(graph["train_idx"][i * batch:(i + 1) * batch])
        met = tr.train_step(g, feats, labels, seeds, torch.ones(batch, dtype=torch.bool), gen)
        assert int(met["frontier_overflow"]) == 0 and np.isfinite(float(met["loss"]))


# ---- metrics ---------------------------------------------------------------------


def test_metrics_logger(tmp_path, capsys):
    """As ``tests/test_checkpoint_metrics.py`` requires of the JAX package's
    logger, plus: stdout means ``sys.stdout``."""
    log = MetricsLogger(path=str(tmp_path / "m.jsonl"), stdout=False)
    log.log("epoch", epoch=1, loss=0.5)
    log.close()
    rec = json.loads(open(tmp_path / "m.jsonl").read().strip())
    assert rec["event"] == "epoch" and rec["loss"] == 0.5
    assert capsys.readouterr().out == ""
    MetricsLogger(stdout=True).log("step", ms=1.5)
    out = capsys.readouterr()
    assert json.loads(out.out)["ms"] == 1.5 and out.err == ""


# ---- checkpoints -----------------------------------------------------------------


def _trained(dtype, seed, steps=2):
    model = TSAGE(8, 16, 4, 2, generator=torch.Generator().manual_seed(seed), device="cpu").to(dtype)
    opt = make_optimizer(model.parameters(), 1e-2, 5e-4)
    for _ in range(steps):
        opt.zero_grad()
        sum((p.float() ** 2).sum() for p in model.parameters()).backward()
        opt.step()
    return model, opt


def _assert_same_state(m1, o1, m2, o2):
    for (k1, a), (k2, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert k1 == k2 and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), k1
    s1, s2 = o1.state_dict()["state"], o2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        for name in s1[i]:
            a, b = s1[i][name], s2[i][name]
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (i, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip_with_adam_state(tmp_path, dtype):
    """The model, Adam's moments and its 0-d per-parameter ``step``, and the
    training step round-trip exactly into a fresh template."""
    model, opt = _trained(dtype, 0)
    assert opt.state_dict()["state"][0]["step"].dim() == 0
    save_checkpoint(str(tmp_path / "ck"), model, opt, 17)
    m2 = TSAGE(8, 16, 4, 2, generator=torch.Generator().manual_seed(9), device="cpu").to(dtype)
    o2 = make_optimizer(m2.parameters(), 1e-2, 5e-4)  # fresh: no state yet
    assert load_checkpoint(str(tmp_path / "ck"), m2, o2) == 17
    _assert_same_state(model, opt, m2, o2)
    # the restored run takes the same next step as the saved one
    for m, o in ((model, opt), (m2, o2)):
        o.zero_grad()
        sum((p.float() ** 2).sum() for p in m.parameters()).backward()
        o.step()
    _assert_same_state(model, opt, m2, o2)


class _Scaled(torch.nn.Module):
    """A 0-d bf16 parameter (and so 0-d bf16 Adam moments)."""

    def __init__(self, v):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(v, dtype=torch.bfloat16))
        self.w = torch.nn.Parameter(torch.full((3,), v, dtype=torch.bfloat16))


def test_checkpoint_zero_d_bf16_leaf(tmp_path):
    """The reference's fault (ROADMAP Queue 3): its byte view of a 0-d
    bfloat16 leaf raises.  The port's round-trips it, and its Adam state."""
    with pytest.raises(ValueError):
        jcheckpoint._flatten({"scale": np.array(1.5, dtype=ml_dtypes.bfloat16)})
    m = _Scaled(1.5)
    opt = torch.optim.Adam(m.parameters(), lr=0.1)
    (m.scale.float() * 3 + m.w.float().sum()).backward()
    opt.step()
    assert opt.state_dict()["state"][0]["exp_avg"].dim() == 0
    save_checkpoint(str(tmp_path / "ck"), m, opt, 1)
    m2 = _Scaled(-2.0)
    o2 = torch.optim.Adam(m2.parameters(), lr=0.1)
    load_checkpoint(str(tmp_path / "ck"), m2, o2)
    assert m2.scale.dim() == 0 and m2.scale.dtype == torch.bfloat16
    _assert_same_state(m, opt, m2, o2)


def test_checkpoint_shape_and_dtype_mismatches_raise(tmp_path):
    model, opt = _trained(torch.bfloat16, 0, steps=1)
    save_checkpoint(str(tmp_path / "ck"), model, opt, 3)
    wide = TSAGE(8, 32, 4, 2, device="cpu").to(torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path / "ck"), wide, make_optimizer(wide.parameters(), 1e-2, 5e-4))
    f32 = TSAGE(8, 16, 4, 2, device="cpu")
    before = {k: v.clone() for k, v in f32.state_dict().items()}
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_checkpoint(str(tmp_path / "ck"), f32, make_optimizer(f32.parameters(), 1e-2, 5e-4))
    assert all(torch.equal(before[k], v) for k, v in f32.state_dict().items())  # nothing loaded
    m = _Scaled(1.0)
    save_checkpoint(str(tmp_path / "small"), m, torch.optim.Adam(m.parameters()), 0)
    more = _Scaled(1.0)
    more.extra = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(KeyError, match="extra"):
        load_checkpoint(str(tmp_path / "small"), more, torch.optim.Adam(more.parameters()))


# ---- utils/timing.profile_device: counting the profiler's lost records ------


@pytest.mark.parametrize(
    "sessions,want_share,want_runs",
    [
        ([(10, 10)], 1.0, 1),  # complete at once
        ([(10, 4), (10, 10), (10, 2)], 1.0, 2),  # the first complete one
        ([(10, 5), (10, 6), (10, 4), (10, 3)], 0.6, 4),  # the largest share, scaled
        ([(10, 0)] * 4, None, 4),  # nothing kept: raises
    ],
)
def test_profile_device_counts_lost_records(monkeypatch, sessions, want_share, want_runs):
    """``profile_device`` (which needs a card to profile) on scripted
    sessions of (launches seen, kernel records kept): it returns the first
    complete session, else the one that kept the largest share with its
    totals divided by that share, and raises when none kept a record."""
    from dist_gnn_tpu_torch.utils import timing

    runs = []

    def fake_session(fn, iters):
        launched, kept = sessions[len(runs)]
        runs.append(iters)
        kernels = {"k": (0.002 * kept, kept)} if kept else {}
        return kernels, 5.0 + len(runs), launched, kept

    monkeypatch.setattr(timing, "_session", fake_session)
    monkeypatch.setattr(timing.torch.cuda, "synchronize", lambda: None)
    for name, value in (("kept_share", 1.0), ("min_kept_share", 1.0), ("sessions", 0),
                        ("sessions_incomplete", 0), ("launches_seen", 0)):
        monkeypatch.setattr(timing.profile_device, name, value)
    calls = []
    if want_share is None:
        with pytest.raises(RuntimeError, match="kept no kernel record"):
            timing.profile_device(lambda: calls.append(1), iters=3)
        assert len(runs) == want_runs and calls == [1]
        return
    kernels, wall = timing.profile_device(lambda: calls.append(1), iters=3)
    assert len(runs) == want_runs and runs == [3] * want_runs and calls == [1]  # one warm-up call
    best = max(range(want_runs), key=lambda i: sessions[i][1] / sessions[i][0])
    assert wall == 5.0 + best + 1
    assert timing.profile_device.kept_share == pytest.approx(want_share)
    assert timing.profile_device.min_kept_share == pytest.approx(want_share)
    assert timing.profile_device.sessions_incomplete == sum(k < n for n, k in sessions[:want_runs])
    assert timing.profile_device.launches_seen == 10 * want_runs
    assert timing.profile_device.sessions == want_runs
    ms, n = kernels["k"]  # every record stands for the lost ones: 10 launches of 0.002 ms
    assert n == pytest.approx(10) and ms == pytest.approx(0.02)
