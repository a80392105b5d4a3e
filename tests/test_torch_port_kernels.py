"""K1 and K3: the plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU) and jnp oracles, and the wrapper contract.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu.ops import gather_pallas as jgp
from dist_gnn_tpu.ops import spmm as jspmm
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tables(N, F, dtype, seed):
    t = np.random.default_rng(seed).standard_normal((N, F)).astype(np.float32)
    jdt, tdt = _DT[dtype]
    return jnp.asarray(t).astype(jdt), torch.from_numpy(t).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---- (f) K1 gather_rows ---------------------------------------------------


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [128, 256])
def test_gather_rows_plain_matches_pallas(F, dtype, group):
    N, L = 64, 37
    jt, tt = _tables(N, F, dtype, F + group)
    idx = np.random.default_rng(group).integers(0, N, L).astype(np.int32)
    ref = jgp.gather_rows(jt, jnp.asarray(idx), group=group)
    out = tgather.gather_rows(tt, torch.from_numpy(idx))
    assert out.dtype == tt.dtype and out.shape == (L, F)
    np.testing.assert_array_equal(_np(ref), out.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_odd_width_and_empty(dtype):
    jt, tt = _tables(50, 37, dtype, 0)
    idx = np.array([3, 3, 49, 0, 17], np.int32)
    out = tgather.gather_rows(tt, torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(jt[jnp.asarray(idx)]), out.float().numpy())
    empty = tgather.gather_rows(tt, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 37) and empty.dtype == tt.dtype


# ---- (g) K3 gather_mean ---------------------------------------------------


def _mean_inputs(cap, S, k, seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, cap, (S, k)).astype(np.int32)
    mask = rng.random((S, k)) < 0.7
    mask[:3] = False  # all-masked rows
    return slots, mask


@pytest.mark.parametrize("S,k", [(12, 5), (9, 15)])
def test_gather_mean_plain_matches_pallas_and_jnp(S, k):
    cap, F = 50, 128
    jh, th = _tables(cap, F, "float32", S)
    slots, mask = _mean_inputs(cap, S, k, k)
    out = tspmm.gather_mean(th, torch.from_numpy(slots), torch.from_numpy(mask))
    for ref in (
        jgp.gather_mean(jh, jnp.asarray(slots), jnp.asarray(mask)),
        jspmm.gather_mean(jh, jnp.asarray(slots), jnp.asarray(mask)),
    ):
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-6)
    assert (out[:3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_mean_wrapper_on_cpu_is_the_plain_version(dtype):
    jh, th = _tables(40, 100, dtype, 1)
    slots, mask = _mean_inputs(40, 16, 10, 2)
    ts, tm = torch.from_numpy(slots), torch.from_numpy(mask)
    out = tgather.gather_mean(th, ts, tm)
    assert torch.equal(out, tspmm.gather_mean(th, ts, tm))
    tol = 1e-5 if dtype == "float32" else 1e-2
    ref = jspmm.gather_mean(jh, jnp.asarray(slots), jnp.asarray(mask))
    np.testing.assert_allclose(_np(ref), out.float().numpy(), rtol=tol, atol=tol)


# ---- (l) the wrapper contract ---------------------------------------------


def test_cpu_wrappers_launch_nothing():
    before = (tgather.gather_rows.launches, tgather.gather_mean.launches)
    th = torch.randn(30, 8)
    tgather.gather_rows(th, torch.arange(5, dtype=torch.int32))
    tgather.gather_mean(th, torch.zeros(4, 3, dtype=torch.int32), torch.ones(4, 3, dtype=torch.bool))
    assert (tgather.gather_rows.launches, tgather.gather_mean.launches) == before == (0, 0)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU must reach the kernel or raise; one on the
    'meta' device is not a CUDA tensor, so both wrappers refuse it."""
    h = torch.empty(30, 8, device="meta")
    with pytest.raises(ValueError):
        tgather.gather_rows(h, torch.empty(5, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        tgather.gather_mean(
            h, torch.empty(4, 3, dtype=torch.int32, device="meta"),
            torch.empty(4, 3, dtype=torch.bool, device="meta"),
        )
    assert tgather.gather_rows.launches == tgather.gather_mean.launches == 0


@pytest.mark.parametrize(
    "F,dtype,offset,vec",
    [(256, torch.bfloat16, 0, 16), (100, torch.bfloat16, 0, 8), (100, torch.float32, 0, 16),
     (37, torch.bfloat16, 0, 2), (128, torch.bfloat16, 1, 2), (64, torch.float32, 2, 8)],
)
def test_vector_width_respects_row_and_pointer_alignment(F, dtype, offset, vec):
    base = torch.zeros(4 * F + 16, dtype=dtype)
    view = base[offset:]
    assert tgather._vec_bytes(F * base.element_size(), view) == vec
