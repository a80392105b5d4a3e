"""The port's apps (``examples/graphsage/node_classification.py``,
``node_classification_dist.py``) and scale smoke (``scripts/bench_scale.py``)
on the CPU at tiny sizes, held to the JAX package's apps.

* Parser parity: every option of JAX's two parsers exists in the port's
  with the same flags, default, type and choices.  The differences are
  asserted: the dist app's ``--tpu`` has no counterpart (the card is the
  default) and it gains ``--cpu``; the single app's ``--cpu`` means the
  CPU device (one device per rank) where JAX's forces 8 CPU devices; both
  apps' ``--model`` adds ``transformer``, a family the JAX package lacks.
* Every mode of ``node_classification.main`` runs on a 2,000-node graph
  with ``--cpu``; checkpoint then ``--resume`` carries the step on.
* Both packages' SAGE app with the same arguments (3 epochs): each
  reaches val_acc >= 0.9 and they lie within 0.05 of each other; the
  metrics logs hold the same events with the same fields.  Runs are
  compared statistically: the two packages draw their keys differently.
* ``node_classification_dist.main`` with ``--cpu --procs 2
  --devices-per-process 1``, both tiers, with a short final batch, and as
  one launcher per host (``--process-id``, ``--coordinator``).
* Without ``--cpu`` every entry point raises here: there is no card.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import math
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dist_gnn_tpu_torch.examples.graphsage import node_classification as nc
from dist_gnn_tpu_torch.examples.graphsage import node_classification_dist as ncd
from dist_gnn_tpu_torch.scripts import bench_scale

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--cpu", "--num-nodes", "2000", "--epochs", "1", "--batch-size", "64", "--fan-out", "5,5",
        "--hidden", "32"]
# 3 epochs of 13 steps each: enough for SAGE to learn the synthetic graph
CONVERGE = ["--num-nodes", "2000", "--epochs", "3", "--batch-size", "16", "--full-eval", "--profile"]


def _jax_app(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / "graphsage" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_parser(name, monkeypatch):
    """The ArgumentParser that JAX's ``parse_args()`` builds, caught as it
    parses an empty command line."""
    caught = []
    orig = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        caught.append(self)
        return orig(self, [], namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    _jax_app(name).parse_args()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return caught[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, tuple(a.choices or ()), a.const)
            for a in parser._actions if a.dest != "help"}


# ---- parser parity ------------------------------------------------------------------

def _without_transformer(port_opts, jax_opts):
    """The port's ``--model`` choices are JAX's and ``transformer``; the
    options with that one difference taken out."""
    dest = port_opts["model"]
    assert dest[3] == jax_opts["model"][3] + ("transformer",)
    return {**port_opts, "model": dest[:3] + (jax_opts["model"][3],) + dest[4:]}


def test_node_classification_parser_is_jax_s(monkeypatch):
    jax_opts = _options(_jax_parser("node_classification", monkeypatch))
    port_opts = _without_transformer(_options(nc.build_parser()), jax_opts)
    assert port_opts == jax_opts
    assert len(port_opts) == 27


def test_node_classification_dist_parser_is_jax_s_but_tpu(monkeypatch):
    jax_opts = _options(_jax_parser("node_classification_dist", monkeypatch))
    port_opts = _without_transformer(_options(ncd.build_parser()), jax_opts)
    # the listed differences: JAX's --tpu (a pod over DCN) has no
    # counterpart, the card is the default; --cpu gives gloo on the CPU
    assert "tpu" in jax_opts and "tpu" not in port_opts
    assert port_opts.pop("cpu") == (("--cpu",), False, None, (), True) and "cpu" not in jax_opts
    jax_opts.pop("tpu")
    assert port_opts == jax_opts


# ---- the device rule --------------------------------------------------------------

def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nc.main(["--num-nodes", "200", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nc.main(["--num-nodes", "200", "--epochs", "1", "--dist"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ncd.main(["--procs", "1", "--devices-per-process", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scale.run(200, 4)


# ---- every mode of node_classification ---------------------------------------------

MODES = {
    "sage": [],
    "gat": ["--model", "gat"],
    "gcn": ["--model", "gcn"],
    "transformer": ["--model", "transformer"],
    "bias": ["--bias"],
    "unroll2": ["--unroll", "2"],
    "unroll3": ["--unroll", "3"],  # 4 batches: a group of 3 and one leftover step
    "profile": ["--profile"],
    "full_eval": ["--full-eval"],
    "bf16_autotune": ["--bf16", "--autotune"],
    "tier_host": ["--tier", "host"],
    "tier_host_struct": ["--tier", "host", "--host-struct"],
    "tier_host_struct_bias": ["--tier", "host", "--host-struct", "--bias"],
    "tier_dist_host": ["--tier", "dist-host"],
    "dist": ["--dist", "--full-eval"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_node_classification_mode_runs(mode, capsys):
    res = nc.main(TINY + MODES[mode])
    out = capsys.readouterr().out
    (ep,) = res["epochs"]
    assert math.isfinite(ep["loss"]) and 0.0 <= ep["train_acc"] <= 1.0
    host = mode.startswith("tier_")
    world = 2 if mode in ("tier_dist_host", "dist") else 1
    assert res["world"] == world and res["param_devices"] == ["cpu"]
    if world == 1:  # the spawned ranks print to their own stdout
        assert "dataset=synthetic nodes=2000" in out and "epoch 0: loss=" in out
    if host:
        assert ep["val_acc"] is None and ep["feat_overflow"] == 0 and ep["feat_miss"] > 0
        assert ep["steps"] == 200 // (64 // world * world)  # drop_last
        if world == 1:
            assert "tier=host: base" in out and "miss/batch=" in out
    else:
        assert 0.0 <= ep["val_acc"] <= 1.0 and ep["steps"] == 4  # 200 train seeds, batch 64
        if world == 1:
            assert "val_acc=" in out
    if mode == "profile":
        assert set(res["profile"]) == {"sampling_ms", "loading_ms", "training_resid_ms", "iteration_ms"}
        assert all(v >= 0 for v in res["profile"].values()) and "profile: Sampling" in out
    else:
        assert res["profile"] is None
    if mode in ("full_eval", "dist"):
        assert 0.0 <= res["test_acc"] <= 1.0
        if world == 1:
            assert "full-graph test accuracy:" in out
    if mode == "bf16_autotune":
        assert "autotuned sampler config: SamplerConfig(frontier_caps=" in out


def test_the_transformer_refuses_full_eval(capsys):
    """The family has no full-graph pass yet: the flag is refused before any
    work, and the message says why."""
    with pytest.raises(SystemExit):
        nc.main(TINY + ["--model", "transformer", "--full-eval"])
    assert "no full-graph pass" in capsys.readouterr().err


def test_bias_needs_probs_in_a_saved_dataset(tmp_path):
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset, save_dataset

    arrays, meta = make_synthetic_dataset(num_nodes=300, avg_degree=4)
    save_dataset(str(tmp_path), "plain", arrays, meta)
    with pytest.raises(ValueError, match="probs"):
        nc.main(["--cpu", "--dataset", "plain", "--root", str(tmp_path), "--bias"])


def test_checkpoint_then_resume_carries_the_step(tmp_path, capsys):
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset, save_dataset

    arrays, meta = make_synthetic_dataset(num_nodes=2000, avg_degree=15, with_probs=True)
    save_dataset(str(tmp_path), "saved", arrays, meta)
    common = TINY + ["--dataset", "saved", "--root", str(tmp_path)]
    ck = str(tmp_path / "ck" / "run1")
    first = nc.main(common + ["--epochs", "2", "--checkpoint", ck])
    assert first["step"] == 8 and (tmp_path / "ck" / "run1.npz").exists()
    second = nc.main(common + ["--resume", ck])
    assert second["step"] == 12
    assert f"resumed from {ck} at step 8" in capsys.readouterr().out


# ---- both packages' SAGE app ----------------------------------------------------------

@pytest.fixture(scope="module")
def both_apps(tmp_path_factory):
    """JAX's app and the port's, with the same arguments and a metrics log
    each: ``{package: (val_accs, test_acc, log lines)}``."""
    tmp = tmp_path_factory.mktemp("apps")
    out = {}
    for pkg in ("jax", "port"):
        log = tmp / f"{pkg}.jsonl"
        argv = CONVERGE + ["--metrics-log", str(log)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if pkg == "jax":
                saved = sys.argv
                sys.argv = ["node_classification.py"] + argv
                try:
                    _jax_app("node_classification").main()
                finally:
                    sys.argv = saved
            else:
                nc.main(["--cpu"] + argv)
        text = buf.getvalue()
        vals = [float(v) for v in re.findall(r"val_acc=([0-9.]+)", text)]
        test = float(re.search(r"full-graph test accuracy: ([0-9.]+)", text).group(1))
        out[pkg] = (vals, test, [json.loads(ln) for ln in log.read_text().splitlines()])
    return out


def test_both_sage_apps_converge_alike(both_apps):
    (vj, tj, _), (vp, tp, _) = both_apps["jax"], both_apps["port"]
    assert len(vj) == len(vp) == 3
    assert vj[-1] >= 0.9 and vp[-1] >= 0.9, (vj, vp)
    assert abs(vj[-1] - vp[-1]) <= 0.05, (vj, vp)
    assert tj >= 0.9 and tp >= 0.9 and abs(tj - tp) <= 0.05, (tj, tp)


def test_metrics_logs_hold_jax_s_events_and_fields(both_apps):
    lj, lp = both_apps["jax"][2], both_apps["port"][2]
    assert [e["event"] for e in lp] == [e["event"] for e in lj] == ["epoch"] * 3 + ["profile", "full_eval"]
    for ej, ep in zip(lj, lp):
        assert set(ep) == set(ej), (ep, ej)
    assert [e["epoch"] for e in lp[:3]] == [0, 1, 2]


# ---- node_classification_dist -----------------------------------------------------

DIST = ["--cpu", "--procs", "2", "--devices-per-process", "1", "--epochs", "2", "--avg-degree", "8",
        "--feature-dim", "16", "--hidden", "16", "--fan-out", "4,4"]
# 150 train seeds over a batch of 64: the third batch is short
DIST_HBM = DIST + ["--tier", "hbm", "--num-nodes", "1500", "--batch-size", "64"]


@pytest.fixture(scope="module")
def dist_hbm():
    return ncd.main(DIST_HBM)


def _check_dist(res, steps):
    assert res["rank"] == 0 and res["world"] == 2 and res["shape"] == [2, 1]
    assert res["backend"] == "gloo" and res["device"] == "cpu"
    assert [e["epoch"] for e in res["epochs"]] == [0, 1]
    for e in res["epochs"]:
        assert e["steps"] == steps and math.isfinite(e["loss"]) and 0.0 <= e["val_acc"] <= 1.0


def test_node_classification_dist_two_ranks_hbm(dist_hbm):
    _check_dist(dist_hbm, 3)


def test_node_classification_dist_two_ranks_dist_host():
    # 20 train seeds under one batch of 512
    _check_dist(ncd.main(DIST + ["--tier", "dist-host", "--num-nodes", "200", "--batch-size", "512"]), 1)


def test_node_classification_dist_one_launcher_per_host(dist_hbm):
    """Multi-host mode: host 1's launcher in a subprocess, host 0's here;
    their ranks meet at the coordinator and train as the one launcher's
    world does, to the same losses."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    argv = DIST_HBM + ["--coordinator", f"localhost:{port}"]
    other = subprocess.Popen(
        [sys.executable, "-m", "dist_gnn_tpu_torch.examples.graphsage.node_classification_dist"] + argv
        + ["--process-id", "1"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        res = ncd.main(argv + ["--process-id", "0"])
        out, _ = other.communicate(timeout=120)
    finally:
        if other.poll() is None:
            other.kill()
    assert other.returncode == 0, out[-2000:]
    _check_dist(res, 3)
    assert [e["loss"] for e in res["epochs"]] == [e["loss"] for e in dist_hbm["epochs"]]


def test_node_classification_dist_refuses_a_lone_coordinator():
    with pytest.raises(SystemExit):
        ncd.main(["--cpu", "--coordinator", "localhost:1"])
    with pytest.raises(SystemExit):
        ncd.main(["--cpu", "--process-id", "0"])


# ---- the scale smoke ----------------------------------------------------------------

def test_bench_scale_runs_at_a_tiny_size(monkeypatch):
    for name, value in (("FAN_OUT", (3, 2)), ("BATCH", 16), ("HIDDEN", 16), ("UNROLL", 2)):
        monkeypatch.setattr(bench_scale, name, value)
    res = bench_scale.run(3000, 5, device="cpu")
    assert res["scale_nodes"] == 3000 and res["scale_edges"] == 30000
    assert res["edges_per_step"] > 0 and res["step_ms"] > 0 and res["card"] is None
    assert res["edges_per_s"] == pytest.approx(res["edges_per_step"] / res["step_ms"] * 1e3)


def test_bench_scale_main_runs_each_size_in_turn(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bench_scale, "run", lambda n, d: calls.append((n, d)) or {"scale_nodes": n})
    bench_scale.main(["500000,2000000", "15"])
    assert calls == [(500_000, 15), (2_000_000, 15)]
    assert [json.loads(line)["scale_nodes"] for line in capsys.readouterr().out.splitlines()] == [500_000, 2_000_000]
    calls.clear()
    bench_scale.main([])
    assert calls == [(10_000_000, 15)]
