"""``cache/autotune.tune_dist_tier`` against the JAX package's: the same
``DistTierConfig``, field for field, on the same graph, seeds and plan
(numpy on both sides, so equality is exact)."""

import dataclasses

import numpy as np
import pytest

from dist_gnn_tpu.cache import autotune as jautotune
from dist_gnn_tpu.dataloading.preprocess import make_synthetic_dataset
from dist_gnn_tpu.graph import INVALID_ID
from dist_gnn_tpu_torch.cache import autotune as tautotune


@pytest.fixture(scope="module")
def graph():
    arrays, _ = make_synthetic_dataset(num_nodes=2000, avg_degree=8, feature_dim=4, num_classes=4,
                                       train_frac=0.4, seed=2)
    return arrays


def _plan(n, C=120, seed=0):
    """Per-rank hot ids, INVALID padded, one rank's row shorter."""
    rng = np.random.default_rng(seed)
    hot = np.stack([rng.permutation(2000)[:C].astype(np.int32) for _ in range(n)])
    hot[-1, C // 2 :] = INVALID_ID
    return hot


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("with_hot", [False, True], ids=["no_plan", "plan"])
def test_tune_dist_tier_equals_jax(graph, n, with_hot):
    args = (graph["indptr"], graph["indices"], graph["train_idx"], 64, (4, 3), n)
    kw = dict(hot_ids=_plan(n) if with_hot else None, trials=2, seed=n)
    want = jautotune.tune_dist_tier(*args, **kw)
    got = tautotune.tune_dist_tier(*args, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.feat_miss_budget >= 256 and got.struct_miss_budget >= 256 and 32 <= got.deg_cap <= 2048
    assert got.exchange_slack >= 1.0 and got.peer_slack >= 1.0


def test_tune_dist_tier_slack_and_num_nodes_equal_jax(graph):
    args = (graph["indptr"], graph["indices"], graph["train_idx"], 48, (5, 2, 2), 2)
    kw = dict(hot_ids=_plan(2, C=400, seed=3), slack=1.0, num_nodes=2048, trials=3, seed=9)
    assert dataclasses.asdict(tautotune.tune_dist_tier(*args, **kw)) == dataclasses.asdict(
        jautotune.tune_dist_tier(*args, **kw))


@pytest.mark.parametrize("x", [0, 1, 31, 32, 33, 100, 4096, 5000])
def test_pow2_at_least_equals_jax(x):
    assert tautotune._pow2_at_least(x) == jautotune._pow2_at_least(x)
    assert tautotune._pow2_at_least(x, 32, 2048) == jautotune._pow2_at_least(x, 32, 2048)
