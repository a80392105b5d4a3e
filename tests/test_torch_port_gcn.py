"""GCN: the port's model and ``Trainer.eval_step`` against the JAX
package's on the same graph, blocks, weights and injected keys.

Everything runs in f32 with rtol = atol = 1e-5: the two packages differ
only in summation order.  ``eval_step`` is held with ``dedup_last`` True
and False, which pins the norm difference of the dedup-free last hop
(``dist_gnn_tpu/models/gcn.py:70-74``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu import graph as jgraph
from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.dataloading import preprocess as jpre
from dist_gnn_tpu.models.gcn import GCN as JGCN
from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu.training import Trainer as JTrainer
from dist_gnn_tpu_torch import graph as tgraph
from dist_gnn_tpu_torch import sampler as tsampler
from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator as TSeedGenerator
from dist_gnn_tpu_torch.models import GCN as TGCN
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.training import Trainer as TTrainer
from dist_gnn_tpu_torch.weights import gcn_params_from_jax

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
    jm = JGCN(12, hidden, meta["num_classes"], num_layers)
    jp = jm.init(jax.random.key(seed))
    tm = TGCN(12, hidden, meta["num_classes"], num_layers, device="cpu")
    tm.load_state_dict(gcn_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _hop_keys(key, blocks, n):
    keys = jax.random.split(key, n)
    return [
        torch.from_numpy(np.asarray(jprng.random_keys(keys[i], (b.num_dst,))).astype(np.int64))
        for i, b in enumerate(blocks)
    ]


def test_gcn_params_from_jax_names_shapes_and_dtypes(data):
    _, meta, _, _ = data
    jm, jp, tm = _models(3, 16, meta)
    sd = gcn_params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(tm.state_dict()) == {f"layer{l}.{n}" for l in range(3) for n in ("w", "b")}
    for name, v in tm.state_dict().items():
        layer, leaf = name.split(".")
        assert tuple(v.shape) == tuple(jp[layer][leaf].shape)
        np.testing.assert_array_equal(np.asarray(jp[layer][leaf]), v.numpy())
        assert v.dtype == torch.float32
    assert tm.layer0.w.shape == (12, 16) and tm.layer2.w.shape == (16, meta["num_classes"])


@pytest.mark.parametrize("contiguous_first", [False, True])
@pytest.mark.parametrize("num_layers,hidden", [(2, 8), (3, 16)])
def test_gcn_logits_match_jax(data, num_layers, hidden, contiguous_first):
    arrays, meta, jhg, thg = data
    fan_out = (4, 3, 2)[:num_layers]
    s = arrays["train_idx"][:24].copy()
    s[-4:] = INVALID
    mask = s != INVALID
    key = jax.random.key(10 + num_layers)
    jblocks, _ = jsampler.sample_blocks(
        jhg.to_device(), jnp.asarray(s), jnp.asarray(mask), fan_out, False, key,
        dedup_last=not contiguous_first,
    )
    tblocks, _ = tsampler.sample_blocks(
        thg.to_device("cpu"), torch.from_numpy(s), torch.from_numpy(mask), fan_out, False,
        _hop_keys(key, jblocks, len(fan_out)), dedup_last=not contiguous_first,
    )
    jm, jp, tm = _models(num_layers, hidden, meta)
    safe = np.where(np.asarray(jblocks[-1].frontier_mask), np.asarray(jblocks[-1].frontier), 0)
    x = arrays["features"][safe]
    ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(x), contiguous_first=contiguous_first)
    out = tm(tuple(reversed(tblocks)), torch.from_numpy(x), contiguous_first=contiguous_first)
    assert out.shape == (24, meta["num_classes"]) and out.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(), rtol=RTOL, atol=ATOL)


def test_gcn_compute_dtype_casts_like_jax(data):
    """bf16 compute: activations and the product in bf16, the output in
    bf16, within bf16 rounding of the JAX model."""
    arrays, meta, jhg, thg = data
    s = arrays["train_idx"][:16].astype(np.int32)
    mask = np.ones(16, bool)
    key = jax.random.key(3)
    jblocks, _ = jsampler.sample_blocks(jhg.to_device(), jnp.asarray(s), jnp.asarray(mask), (3, 2), False, key)
    tblocks, _ = tsampler.sample_blocks(
        thg.to_device("cpu"), torch.from_numpy(s), torch.from_numpy(mask), (3, 2), False,
        _hop_keys(key, jblocks, 2),
    )
    jm = JGCN(12, 8, meta["num_classes"], 2, compute_dtype=jnp.bfloat16)
    jp = jm.init(jax.random.key(0))
    tm = TGCN(12, 8, meta["num_classes"], 2, compute_dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(gcn_params_from_jax(jax.tree.map(np.asarray, jp)))
    safe = np.where(np.asarray(jblocks[-1].frontier_mask), np.asarray(jblocks[-1].frontier), 0)
    x = arrays["features"][safe]
    ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(x))
    out = tm(tuple(reversed(tblocks)), torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        np.asarray(ref.astype(jnp.float32)), out.float().detach().numpy(), rtol=5e-2, atol=5e-2
    )


@pytest.mark.parametrize("dedup_last", [True, False])
def test_gcn_eval_step_matches_jax(data, dedup_last):
    arrays, meta, jhg, thg = data
    fan_out = (4, 3, 2)
    jm, jp, tm = _models(3, 16, meta, seed=1)
    jtr = JTrainer(model=jm, fan_out=fan_out, dedup_last=dedup_last)
    ttr = TTrainer(model=tm, fan_out=fan_out, dedup_last=dedup_last, device="cpu")
    jg, tg = jhg.to_device(), thg.to_device("cpu")
    feats, labels = arrays["features"], arrays["labels"]
    tfeats, tlabels = torch.from_numpy(feats), torch.from_numpy(labels)
    gen = TSeedGenerator(arrays["train_idx"][:60], 24, device="cpu")
    total = 0
    for b, (seeds, mask) in enumerate(gen.epoch()):
        key = jax.random.key(200 + b)
        s_np, m_np = seeds.numpy(), mask.numpy()
        jblocks, _ = jsampler.sample_blocks(
            jg, jnp.asarray(s_np), jnp.asarray(m_np), fan_out, False, key, dedup_last=dedup_last
        )
        hop_keys = _hop_keys(key, jblocks, len(fan_out))
        jc, jn = jtr.eval_step(jp, jg, jnp.asarray(feats), jnp.asarray(labels),
                               jnp.asarray(s_np), jnp.asarray(m_np), key)
        tc, tn = ttr.eval_step(None, tg, tfeats, tlabels, seeds, mask, hop_keys)
        assert (int(jc), int(jn)) == (int(tc), int(tn))
        total += int(tn)
        tblocks, _ = tsampler.sample_blocks(tg, seeds, mask, fan_out, False, hop_keys, dedup_last=dedup_last)
        safe = np.where(np.asarray(jblocks[-1].frontier_mask), np.asarray(jblocks[-1].frontier), 0)
        ref = jm.apply(jp, tuple(reversed(jblocks)), jnp.asarray(feats[safe]), contiguous_first=not dedup_last)
        with torch.no_grad():
            out = tm(tuple(reversed(tblocks)), tfeats[safe], contiguous_first=not dedup_last)
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=RTOL, atol=ATOL)
    assert total == 60
    assert tgather.gather_rows.launches == 0


def test_gcn_dropout_needs_keys_and_uses_them(data):
    arrays, meta, _, thg = data
    tm = TGCN(12, 8, meta["num_classes"], 2, generator=torch.Generator().manual_seed(0), device="cpu")
    s = torch.from_numpy(arrays["train_idx"][:8].astype(np.int32))
    blocks, _ = tsampler.sample_blocks(
        thg.to_device("cpu"), s, torch.ones(8, dtype=torch.bool), (3, 2), False,
        torch.Generator().manual_seed(1),
    )
    safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0).long()
    x = torch.from_numpy(arrays["features"])[safe]
    blks = tuple(reversed(blocks))
    with pytest.raises(ValueError, match="rng"):
        tm(blks, x, train=True)
    a = tm(blks, x, train=True, rng=torch.Generator().manual_seed(5))
    b = tm(blks, x, train=True, rng=torch.Generator().manual_seed(5))
    c = tm(blks, x, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
