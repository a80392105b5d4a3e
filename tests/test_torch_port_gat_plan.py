"""K4/K5 at the widths the tensor-core path pads, and the launch plan.

(a) The plain versions :func:`gat_fwd_plain` / :func:`gat_bwd_plain`, which
the card holds the kernels to, against JAX's ``_fwd_call`` / ``_bwd_call``
(Pallas in interpret mode on the CPU) at the GAT bench's awkward widths:
E 100 with D 128 and E 512 with D 47 (E not a multiple of 16, D not of 8).
S is 256, which JAX's blocks divide (256 rows forward for E <= 128, 128 for
E <= 512; half that backward).  f32 throughout: 1e-5 forward (summation
order only), 1e-4 backward (as tests/test_torch_port_gat.py).

(b) :func:`gat_plan`, pure arithmetic: at the bench layers and the
envelope's corners every plan fits one block's shared memory, its row
tiles cover S, the bf16 padding is a multiple of 16, and a shape outside
the envelope raises ``ValueError``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu.ops import gat_pallas as jgp
from dist_gnn_tpu_torch.ops import gat as tgat

torch.set_num_threads(1)
SLOPE = 0.2
S, K, H = 256, 3, 4
WIDTHS = [(100, 128), (512, 47)]  # (E, D)


def _inputs(seed, E, D):
    """x_n, el, er3, mask_f, w, g as numpy f32; row 0 fully masked."""
    rng = np.random.default_rng(seed)
    x_n = rng.standard_normal((K, S, E)).astype(np.float32)
    x_dst = rng.standard_normal((S, E)).astype(np.float32)
    wal = (rng.standard_normal((E, H)) * 0.1).astype(np.float32)
    war = (rng.standard_normal((E, H)) * 0.1).astype(np.float32)
    mask = (rng.random((S, K)) < 0.8).astype(np.float32)
    mask[0] = 0
    el = x_dst @ wal
    er3 = (x_n.reshape(K * S, E) @ war).reshape(K, S, H)
    w = (rng.standard_normal((E, H * D)) * 0.1).astype(np.float32)
    g = rng.standard_normal((S, H * D)).astype(np.float32)
    return x_n, el, er3, mask, w, g


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("E,D", WIDTHS)
def test_gat_fwd_plain_matches_pallas_fwd_at_padded_widths(E, D):
    x_n, el, er3, mask, w, _ = _inputs(E + D, E, D)
    ref = jgp._fwd_call(*map(jnp.asarray, (x_n, el, er3, mask, w)), SLOPE)
    out = tgat.gat_fwd_plain(*_t((x_n, el, er3, mask, w)), SLOPE)
    assert out.shape == (S, H * D) and out.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("E,D", WIDTHS)
def test_gat_bwd_plain_matches_pallas_bwd_at_padded_widths(E, D, need_dx):
    arrays = _inputs(E * D, E, D)
    ref = jgp._bwd_call(*map(jnp.asarray, arrays), SLOPE, need_dx)
    out = tgat.gat_bwd_plain(*_t(arrays), SLOPE, need_dx)
    for name, r, o in zip(("dw", "d_el", "d_er3"), ref, out):
        np.testing.assert_allclose(np.asarray(r), o.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    if need_dx:
        np.testing.assert_allclose(np.asarray(ref[3]), out[3].numpy(), rtol=1e-4, atol=1e-4)
        assert torch.all(out[3][:, 0] == 0)
    else:
        assert out[3] is None


# ---- the plan ------------------------------------------------------------------

BENCH_LAYERS = [(33792, 15, 100, 4, 128), (3072, 10, 512, 4, 128), (512, 5, 512, 4, 47)]  # S, K, E, H, D
CORNERS = list(itertools.product((1, 511, 33792), (1, 32), (1, 100, 1024), (1, 8), (1, 47, 128)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_plan_fits_and_covers_at_bench_layers_and_corners(kernel, dtype):
    for S_, K_, E_, H_, D_ in BENCH_LAYERS + CORNERS:
        p = tgat.gat_plan(kernel, K_, S_, E_, H_, D_, dtype)
        where = (kernel, dtype, S_, K_, E_, H_, D_, p)
        assert 0 < p.smem_bytes <= tgat.SMEM_BLOCK_MAX, where
        assert p.rows * p.grid[0] >= S_ > p.rows * (p.grid[0] - 1), where
        assert p.heads_per_block * p.grid[1] >= H_ > p.heads_per_block * (p.grid[1] - 1), where
        assert p.blocks_per_sm >= 1 and p.waves > 0, where
        if dtype == torch.bfloat16:
            assert p.rows in (16, 32, 64), where
            assert p.e_pad % 16 == 0 and E_ <= p.e_pad < E_ + 16, where
            assert p.d_pad % 8 == 0 and p.d_pad % 16 == 0 and D_ <= p.d_pad < D_ + 16, where
            if kernel == "fwd":
                assert p.w_rows % 16 == 0 and 16 <= p.w_rows <= p.e_pad, where
        else:
            assert 1 <= p.rows <= 16 and p.heads_per_block == H_, where
        if kernel == "bwd":
            assert p.heads_per_block == H_, where  # dxn sums every head
            assert p.dw_s_chunk % 32 == 0, where
            assert p.dw_splits * p.dw_s_chunk >= S_ > (p.dw_splits - 1) * p.dw_s_chunk, where
        else:
            assert p.dw_splits == p.dw_s_chunk == 0, where


def test_plan_splits_heads_where_rows_cannot_fill_the_card():
    """The bench's last layer has 32 row tiles of 16: K4 splits its heads
    across blocks; the first layer has rows enough and keeps them whole."""
    first = tgat.gat_plan("fwd", 15, 33792, 100, 4, 128, torch.bfloat16)
    last = tgat.gat_plan("fwd", 5, 512, 512, 4, 47, torch.bfloat16)
    assert first.heads_per_block == 4 and first.grid[0] * first.grid[1] >= 2 * tgat.NUM_SMS
    assert last.heads_per_block < 4 and last.grid[0] * last.grid[1] > -(-512 // last.rows)
    # more SMs never make a plan with fewer blocks
    for S_, K_, E_, H_, D_ in BENCH_LAYERS:
        small = tgat.gat_plan("fwd", K_, S_, E_, H_, D_, torch.bfloat16, num_sms=16)
        big = tgat.gat_plan("fwd", K_, S_, E_, H_, D_, torch.bfloat16, num_sms=132)
        assert small.grid[0] * small.grid[1] <= big.grid[0] * big.grid[1]


@pytest.mark.parametrize(
    "K_,S_,E_,H_,D_",
    [(0, 8, 16, 2, 8), (33, 8, 16, 2, 8), (4, 8, 0, 2, 8), (4, 8, 1025, 2, 8),
     (4, 8, 16, 0, 8), (4, 8, 16, 9, 8), (4, 8, 16, 2, 0), (4, 0, 16, 2, 8)],
)
def test_plan_raises_outside_the_envelope(K_, S_, E_, H_, D_):
    for kernel, dtype in itertools.product(("fwd", "bwd"), (torch.bfloat16, torch.float32)):
        with pytest.raises(ValueError):
            tgat.gat_plan(kernel, K_, S_, E_, H_, D_, dtype)


def test_plan_raises_when_no_tile_fits():
    """A head width whose tiles exceed shared memory (or K4's accumulators)
    is refused before any launch; so are other dtypes and kernel names."""
    for kernel in ("fwd", "bwd"):
        with pytest.raises(ValueError, match="no .* tile fits"):
            tgat.gat_plan(kernel, 4, 64, 64, 8, 4096, torch.bfloat16)
    with pytest.raises(ValueError):
        tgat.gat_plan("fwd", 4, 64, 64, 2, 8, torch.float16)
    with pytest.raises(ValueError):
        tgat.gat_plan("sideways", 4, 64, 64, 2, 8, torch.bfloat16)
