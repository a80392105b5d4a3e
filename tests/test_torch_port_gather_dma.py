"""K2: the plain version against the JAX package's Pallas kernel
(``gather_rows_dma``, interpret mode on the CPU), the wrapper contract,
``measure_chain`` and the gather bench entry point.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
the plain version there.  Outputs are exact: a gather copies bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_gnn_tpu.ops import gather_pallas as jgp
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.scripts import bench_gather2
from dist_gnn_tpu_torch.utils.timing import measure_chain

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype,B", [("float32", 32), ("float32", 128), ("bfloat16", 32)])
def test_gather_rows_dma_plain_matches_pallas(dtype, B):
    """L = 300 leaves a partial last step at both B."""
    N, F, L = 64, 128, 300
    t = np.random.default_rng(B).standard_normal((N, F)).astype(np.float32)
    jdt, tdt = _DT[dtype]
    idx = np.random.default_rng(1).integers(0, N, L).astype(np.int32)
    ref = jgp.gather_rows_dma(jnp.asarray(t).astype(jdt), jnp.asarray(idx), rows_per_step=B)
    tt = torch.from_numpy(t).to(tdt)
    ti = torch.from_numpy(idx)
    for out in (tgather.gather_rows_dma_plain(tt, ti), tgather.gather_rows_dma(tt, ti, rows_per_step=B)):
        assert out.dtype == tdt and out.shape == (L, F)
        np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)), out.float().numpy())
    assert tgather.gather_rows_dma.launches == 0


def test_gather_rows_dma_wrapper_contract():
    t = torch.randn(50, 37).to(torch.bfloat16)
    empty = tgather.gather_rows_dma(t, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 37) and empty.dtype == t.dtype
    # an int64 idx on the CPU returns as K1's does
    idx64 = torch.tensor([3, 3, 49, 0], dtype=torch.int64)
    assert torch.equal(tgather.gather_rows_dma(t, idx64), tgather.gather_rows(t, idx64))
    for bad in (0, -4):
        with pytest.raises(ValueError, match="rows_per_step"):
            tgather.gather_rows_dma(t, idx64.int(), rows_per_step=bad)
    # off the CPU: the kernel or a raise, never the plain version
    meta = torch.empty(30, 8, device="meta")
    with pytest.raises(ValueError):
        tgather.gather_rows_dma(meta, torch.empty(5, dtype=torch.int32, device="meta"))
    assert tgather.gather_rows_dma.launches == tgather.gather_rows.launches == 0


def test_dma_stage_bytes_names_the_shared_memory_need():
    # an f32 row of 128 columns: B = 256 and 512 exceed the H100's 232448 B
    assert tgather.dma_stage_bytes(512, 128) == 131072
    assert tgather.dma_stage_bytes(512, 256) == 262144 > 232448
    assert tgather.dma_stage_bytes(256, 256) == 131072
    with pytest.raises(ValueError):
        tgather.smem_optin_bytes(torch.device("cpu"))


def test_measure_chain_gives_a_positive_slope_on_the_cpu():
    x = torch.randn(64, 64)

    def step(carry):
        i, acc = carry
        return i + 1, acc + (x @ x).sum()

    dt = measure_chain(step, (0, torch.zeros(())), n_lo=2, n_hi=6, reps=2)
    assert 0 < dt < 1.0


def test_bench_gather_runs_on_the_cpu(capsys):
    res = bench_gather2.main(device="cpu", n=256, f=8, l=1000)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and lines[1] == "k2 correctness OK"
    names = ["index_select_bf16", "index_select_f32", "k1_bf16"] + [
        f"k2_{t}_b{b}" for t in ("bf16", "f32") for b in bench_gather2.ROWS_PER_STEP
    ]
    assert [r["variant"] for r in res] == names
    assert [ln.split(":")[0] for ln in lines[2:]] == names
    assert all(r["launched"] and r["ms"] > 0 and "rows/s" in ln for r, ln in zip(res, lines[2:]))
    assert res[-1]["row_bytes"] == 32 and res[0]["row_bytes"] == 16
    assert tgather.gather_rows_dma.launches == 0


def test_bench_gather_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_gather2.main()
