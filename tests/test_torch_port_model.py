"""SAGE, Trainer.eval_step and full-graph inference: the port against the
JAX package on the same graph, features, weights and injected keys.

Everything runs in f32 with rtol 1e-5 (atol 1e-5 for values near 0): the
two packages differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models import inference as jinf
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.training import Trainer as JTrainer
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator as TSeedGenerator
from dist_gnn_tpu_torch.models import inference as tinf
from dist_gnn_tpu_torch.models.sage import SAGE as TSAGE
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.training import Trainer as TTrainer
from dist_gnn_tpu_torch.weights import sage_params_from_jax

torch.set_num_threads(1)
RTOL = ATOL = 1e-5
INVALID = int(jgraph.INVALID_ID)


@pytest.fixture(scope="module")
def data():
    arrays, meta = jpre.make_synthetic_dataset(
        num_nodes=400, avg_degree=5, feature_dim=12, num_classes=6, train_frac=0.3, seed=1
    )
    jhg = jgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    thg = tgraph.HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    return arrays, meta, jhg, thg


def _models(num_layers, hidden, meta, seed=0):
    jm = JSAGE(12, hidden, meta["num_classes"], num_layers)
    jp = jm.init(jax.random.key(seed))
    tm = TSAGE(12, hidden, meta["num_classes"], num_layers, device="cpu")
    tm.load_state_dict(sage_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _hop_keys(key, blocks, n):
    keys = jax.random.split(key, n)
    return [
        torch.from_numpy(np.asarray(jprng.random_keys(keys[i], (b.num_dst,))).astype(np.int64))
        for i, b in enumerate(blocks)
    ]


def _seeds(arrays, n=24, pad=4):
    s = arrays["train_idx"][:n].copy()
    s[-pad:] = INVALID
    return s, s != INVALID


def test_sage_params_from_jax_names_shapes_and_dtypes(data):
    _, meta, _, _ = data
    jm, jp, tm = _models(3, 16, meta)
    sd = sage_params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(tm.state_dict()) == {
        f"layer{l}.{n}" for l in range(3) for n in ("w_self", "w_neigh", "b")
    }
    for name, v in tm.state_dict().items():
        layer, leaf = name.split(".")
        np.testing.assert_array_equal(np.asarray(jp[layer][leaf]), v.numpy())
        assert v.dtype == torch.float32


@pytest.mark.parametrize("contiguous_first", [False, True])
@pytest.mark.parametrize("num_layers,hidden", [(2, 32), (3, 16)])
def test_sage_logits_match_jax(data, num_layers, hidden, contiguous_first):
    arrays, meta, jhg, thg = data
    fan_out = (4, 3, 2)[:num_layers]
    seeds, mask = _seeds(arrays)
    key = jax.random.key(num_layers)
    jblocks, _ = jsampler.sample_blocks(
        jhg.to_device(), jnp.asarray(seeds), jnp.asarray(mask), fan_out, False, key,
        dedup_last=not contiguous_first,
    )
    tblocks, _ = tsampler.sample_blocks(
        thg.to_device("cpu"), torch.from_numpy(seeds), torch.from_numpy(mask), fan_out, False,
        _hop_keys(key, jblocks, len(fan_out)), dedup_last=not contiguous_first,
    )
    jm, jp, tm = _models(num_layers, hidden, meta)
    safe = np.where(np.asarray(jblocks[-1].frontier_mask), np.asarray(jblocks[-1].frontier), 0)
    x = arrays["features"][safe]
    ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(x), contiguous_first=contiguous_first)
    out = tm(tuple(reversed(tblocks)), torch.from_numpy(x), contiguous_first=contiguous_first)
    assert out.shape == (24, meta["num_classes"])
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dedup_last", [True, False])
def test_eval_step_matches_jax(data, dedup_last):
    arrays, meta, jhg, thg = data
    fan_out = (4, 3, 2)
    jm, jp, tm = _models(3, 16, meta)
    jtr = JTrainer(model=jm, fan_out=fan_out, dedup_last=dedup_last)
    ttr = TTrainer(model=tm, fan_out=fan_out, dedup_last=dedup_last, device="cpu")
    jg, tg = jhg.to_device(), thg.to_device("cpu")
    feats, labels = arrays["features"], arrays["labels"]
    tfeats, tlabels = torch.from_numpy(feats), torch.from_numpy(labels)
    gen = TSeedGenerator(arrays["train_idx"][:100], 24, device="cpu")
    total = 0
    for b, (seeds, mask) in enumerate(gen.epoch()):
        key = jax.random.key(100 + b)
        s_np, m_np = seeds.numpy(), mask.numpy()
        jblocks, _ = jsampler.sample_blocks(
            jg, jnp.asarray(s_np), jnp.asarray(m_np), fan_out, False, key, dedup_last=dedup_last
        )
        hop_keys = _hop_keys(key, jblocks, len(fan_out))
        jc, jn = jtr.eval_step(jp, jg, jnp.asarray(feats), jnp.asarray(labels),
                               jnp.asarray(s_np), jnp.asarray(m_np), key)
        tc, tn = ttr.eval_step(None, tg, tfeats, tlabels, seeds, mask, hop_keys)
        assert (int(jc), int(jn)) == (int(tc), int(tn))
        # the same answer through an explicit state_dict
        tc2, _ = ttr.eval_step(tm.state_dict(), tg, tfeats, tlabels, seeds, mask, hop_keys)
        assert int(tc2) == int(tc)
        total += int(tn)
        # logits on the same blocks
        tblocks, _ = tsampler.sample_blocks(tg, seeds, mask, fan_out, False, hop_keys, dedup_last=dedup_last)
        safe = np.where(np.asarray(jblocks[-1].frontier_mask), np.asarray(jblocks[-1].frontier), 0)
        ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(feats[safe]), contiguous_first=not dedup_last)
        with torch.no_grad():
            out = tm(tuple(reversed(tblocks)), tfeats[safe], contiguous_first=not dedup_last)
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=RTOL, atol=ATOL)
    assert total == 100
    assert tgather.gather_rows.launches == tgather.gather_mean.launches == 0


@pytest.mark.parametrize("edge_chunk", [64, 1 << 18])
def test_full_graph_inference_matches_jax(data, edge_chunk):
    arrays, meta, jhg, thg = data
    jm, jp, tm = _models(3, 16, meta, seed=2)
    feats = arrays["features"]
    ref = jinf.full_graph_inference(jm, jp, jhg, jnp.asarray(feats))
    out = tinf.full_graph_inference(tm, None, thg, torch.from_numpy(feats), edge_chunk=edge_chunk, device="cpu")
    assert out.shape == (meta["num_nodes"], meta["num_classes"])
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=RTOL, atol=ATOL)
    # weights passed as a state_dict give the same output
    out2 = tinf.full_graph_inference(
        TSAGE(12, 16, meta["num_classes"], 3, device="cpu"), tm.state_dict(), thg,
        torch.from_numpy(feats), edge_chunk=edge_chunk, device="cpu",
    )
    assert torch.equal(out, out2)


def test_full_graph_inference_rejects_other_models(data):
    _, _, _, thg = data
    with pytest.raises(NotImplementedError):
        tinf.full_graph_inference(torch.nn.Linear(2, 2), None, thg, torch.zeros(400, 12), device="cpu")


def test_entry_points_raise_without_a_card(data, monkeypatch):
    """The default device is the card: with none, every entry point raises
    instead of falling back to the CPU."""
    arrays, meta, _, thg = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = TSAGE(12, 16, meta["num_classes"], 3, device="cpu")
    for call in (
        lambda: thg.to_device(),
        lambda: TSAGE(12, 16, 6, 3),
        lambda: TTrainer(model=tm, fan_out=(2, 2, 2)),
        lambda: TSeedGenerator(arrays["train_idx"], 8),
        lambda: tinf.full_graph_inference(tm, None, thg, torch.from_numpy(arrays["features"])),
        lambda: thg.to_device("cuda"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert thg.to_device("cpu").indices.device.type == "cpu"
