"""The plain reference against the program's plain CPU path at a tiny
size: the same blocks bit for bit, the same forward passes, the same Adam
and the same full-graph pass (float32 on both sides)."""

import pytest
import torch

from gnnbench import common
from gnnbench.graphgen import make_graph
from gnnbench.reference import models as ref_models
from gnnbench.reference import sampler as ref_sampler
from gnnbench.tests.small import config

CPU = torch.device("cpu")
FANOUT = (15, 10, 5)


@pytest.fixture(scope="module")
def inputs():
    return make_graph(config("sage-products"), 2**31 + 99, CPU)


def program_graph(g):
    from dist_gnn_tpu_torch.graph import Graph

    ip, ix = g["indptr"], g["indices"]
    return Graph(indptr=ip, indices=ix, probs=None, num_nodes=ip.numel() - 1, num_edges=ix.numel(),
                 max_degree=int((ip[1:] - ip[:-1]).max()))


def batch(g, B, caps, seed=5):
    gen = torch.Generator().manual_seed(seed)
    seeds = g["train_idx"][:B].clone()
    seeds[-3:] = ref_sampler.INVALID
    mask = seeds != ref_sampler.INVALID
    sizes = ref_sampler.hop_sizes(B, FANOUT, caps)
    keys = [torch.randint(0, 2**32, (s,), generator=gen, dtype=torch.int64) for s in sizes]
    drops = [torch.randint(0, 2**32, (s,), generator=gen, dtype=torch.int64) for s in reversed(sizes)][:2]
    return seeds, mask, keys, drops


@pytest.mark.parametrize("caps", [None, (200, 1500, 10**9)])
def test_blocks_equal_the_programs(inputs, caps):
    from dist_gnn_tpu_torch.sampler import sample_blocks

    seeds, mask, keys, _ = batch(inputs, 64, caps)
    got, _ = sample_blocks(program_graph(inputs), seeds, mask, FANOUT, False, keys, frontier_caps=caps,
                           dedup_last=False)
    want = ref_sampler.sample_blocks(inputs["indptr"], inputs["indices"], seeds, mask, FANOUT, caps, keys)
    from gnnbench.drivers.train import count_block_diffs

    assert count_block_diffs([b._asdict() for b in got], want) == 0
    assert sum(int(b.neigh_mask.sum()) for b in want) > 64


@pytest.mark.parametrize("family", ["sage", "gat"])
def test_forward_equals_the_programs_in_float32(inputs, family):
    from dist_gnn_tpu_torch.models.gat import GAT
    from dist_gnn_tpu_torch.models.sage import SAGE
    from dist_gnn_tpu_torch.sampler import sample_blocks

    cfg = config(f"{family}-products")
    weights = common.make_weights(cfg, 3, CPU)
    m = cfg["model"]
    if family == "sage":
        model = SAGE(100, m["hidden"], 47, 3, device="cpu", dropout=0.5)
    else:
        model = GAT(100, m["hidden"], 47, 3, num_heads=4, dropout=0.5, negative_slope=m["negative_slope"],
                    device="cpu")
    model.load_state_dict(weights)
    caps = (200, 1500, 10**9)
    seeds, mask, keys, drops = batch(inputs, 64, caps)
    blocks, _ = sample_blocks(program_graph(inputs), seeds, mask, FANOUT, False, keys, frontier_caps=caps,
                              dedup_last=False)
    blocks = tuple(reversed(blocks))
    x = inputs["features"][torch.where(blocks[0].frontier_mask, blocks[0].frontier, 0).long()].float()
    got = model(blocks, x, train=True, rng=list(drops), contiguous_first=True)
    want = ref_models.family(family).forward(weights, blocks, x, drops, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_adam_equals_torchs():
    gen = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(3, generator=gen)}
    leaves = [torch.nn.Parameter(v.clone()) for v in params.values()]
    opt = torch.optim.Adam(leaves, lr=1e-3, weight_decay=5e-4)
    ref = ref_models.Adam(params, 1e-3, 5e-4)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        for p, g in zip(leaves, grads.values()):
            p.grad = g.clone()
        opt.step()
        params = ref.step(params, grads)
    for p, v in zip(leaves, params.values()):
        torch.testing.assert_close(p.detach(), v, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("family", ["sage", "gat"])
def test_full_pass_equals_the_programs(inputs, family):
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models.inference import full_graph_inference

    from gnnbench import programs

    cfg = config(f"{family}-products")
    cfg["model"]["compute_dtype"] = "float32"
    weights = common.make_weights(cfg, 4, CPU)
    model = programs.build(cfg, "cpu")
    model.load_state_dict(weights)
    hg = HostGraph(indptr=inputs["indptr"].numpy(), indices=inputs["indices"].numpy())
    x = inputs["features"].float()
    got = full_graph_inference(model, None, hg, x, device="cpu")
    want = ref_models.full(cfg, weights, inputs["indptr"], inputs["indices"], x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_a_family_is_found_by_name():
    for family in ("sage", "gat"):
        cfg = config(f"{family}-products")
        fam = ref_models.family(family)
        assert set(common.make_weights(cfg, 1, CPU)) == set(fam.param_shapes(cfg))
        assert len(fam.layer_dims(cfg)) == cfg["model"]["num_layers"]
