"""K3-csr, the full-graph walk (``ops/gather.gather_mean_csr``), on the CPU:
its plain version against the walk it replaced (``_edge_sum`` and the
mean) and a float64 oracle, the heavy-row plan against numpy, a numpy
model of the kernels' order of summation, and the wrappers' checks.

Tolerances: f32 results within 1e-5 of the row's largest magnitude
(summation order only); bf16 within one bf16 ulp (2**-7 relative, the
rounding of an f32 sum that differs from the oracle's in its last bits).
"""

import numpy as np
import pytest
import torch

from dist_gnn_tpu_torch.models import inference as tinf
from dist_gnn_tpu_torch.ops import gather as tgather

torch.set_num_threads(1)
LIGHT = tgather.CSR_LIGHT_MAX
HEAVY_WARPS = 16  # csrc/gather.cu kCsrHeavyWarps: the runs a heavy row is cut into


def _graph(seed=0, N=700, hub=LIGHT + 44, max_deg=30):
    """A CSC with isolated rows, one row at the light limit, one just above
    it and a hub above it."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg, N)
    deg[::9] = 0
    deg[4], deg[5], deg[N - 2] = LIGHT, LIGHT + 1, hub
    indptr = np.zeros(N + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, N, indptr[-1]).astype(np.int32)
    return torch.from_numpy(indptr), torch.from_numpy(indices)


def _h(N, F, dtype, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((N, F)).astype(np.float32)).to(dtype)


def _oracle(h, indptr, indices, mean):
    """float64 sums per row, divided by max(deg, 1) for the mean."""
    hd, ip, ix = h.double().numpy(), indptr.numpy(), indices.numpy()
    out = np.zeros(hd.shape)
    for r in range(len(ip) - 1):
        rows = hd[ix[ip[r] : ip[r + 1]]]
        if len(rows):
            out[r] = rows.sum(0) / (max(len(rows), 1) if mean else 1)
    return out


def _close(got, want, dtype):
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    assert (np.abs(got.double().numpy() - want) <= tol * scale).all()


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("F", [100, 256])
def test_plain_is_the_walk_it_replaced(F, dtype, mean):
    """Chunks of 64 edges split the hub and many rows across chunks."""
    indptr, indices = _graph()
    N = indptr.numel() - 1
    h = _h(N, F, dtype)
    got = tgather.gather_mean_csr_plain(h, indptr, indices, mean, edge_chunk=64)
    ssum = tinf._edge_sum(h, indices, tinf._edge_rows(indptr, N, indices.numel()), 64)
    deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
    want = (ssum / torch.clamp(deg, min=1)[:, None] if mean else ssum).to(dtype)
    assert got.dtype == dtype and got.shape == (N, F)
    assert torch.equal(got, want)
    _close(got, _oracle(h, indptr, indices, mean), dtype)
    assert (got[deg == 0] == 0).all()


def test_the_wrapper_on_cpu_is_the_plain_version():
    indptr, indices = _graph(seed=3)
    h = _h(indptr.numel() - 1, 37, torch.bfloat16)
    for mean in (True, False):
        assert torch.equal(tgather.gather_mean_csr(h, indptr, indices, mean, edge_chunk=50),
                           tgather.gather_mean_csr_plain(h, indptr, indices, mean, edge_chunk=50))
    assert tgather.gather_mean_csr.launches == 0 and tgather.csr_plan.launches == 0


@pytest.mark.parametrize(
    "degrees",
    [[0, 3, 5], [LIGHT, LIGHT + 1, 0, 2 * LIGHT, 1], [0, 0, 0], [LIGHT + 7] * 4],
    ids=["light", "mixed", "edgeless", "all_heavy"],
)
def test_the_plan_is_the_heavy_rows_numpy_finds(degrees):
    deg = np.asarray(degrees, np.int64)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int64))
    plan = tgather.csr_plan(indptr, int(deg.sum()))
    heavy = np.nonzero(deg > LIGHT)[0]
    n = int(plan.n_heavy)
    assert n == len(heavy) and int(plan.heavy_edges) == int(deg[heavy].sum())
    assert plan.rows.shape == (len(deg),) and plan.rows.dtype == torch.int32
    assert plan.rows[:n].tolist() == heavy.tolist() and (plan.rows[n:] == -1).all()
    assert plan.n_heavy.dim() == 0 and plan.heavy_edges.dim() == 0


def kernel_model(h, indptr, indices, mean, heavy_order):
    """The kernels' arithmetic in float32: a light row summed in CSC order;
    a heavy row (taken in ``heavy_order``, as blocks pick them) cut into
    HEAVY_WARPS contiguous runs of ceil(n / HEAVY_WARPS) edges, each summed
    in order, the runs' sums added in warp order; the sum divided by
    max(deg, 1) for the mean, then rounded once to h's dtype."""
    hf, ip, ix = h.float().numpy(), indptr.numpy(), indices.numpy()
    out = np.zeros(hf.shape, np.float32)
    deg = np.diff(ip)

    def run_sum(rows):
        acc = np.zeros(hf.shape[1], np.float32)
        for x in rows:
            acc = acc + x  # float32, one edge at a time
        return acc

    def finish(r, acc):
        out[r] = acc / np.float32(max(deg[r], 1)) if mean else acc

    for r in np.nonzero(deg <= LIGHT)[0]:
        finish(r, run_sum(hf[ix[ip[r] : ip[r + 1]]]))
    for r in heavy_order:
        rows = hf[ix[ip[r] : ip[r + 1]]]
        run = -(-len(rows) // HEAVY_WARPS)
        acc = np.zeros(hf.shape[1], np.float32)
        for w in range(HEAVY_WARPS):
            acc = acc + run_sum(rows[w * run : (w + 1) * run])
        finish(r, acc)
    return torch.from_numpy(out).to(h.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_kernels_order_of_work_is_deterministic_and_matches_the_plain(dtype):
    """Two heavy rows (a hub of 1,000 in-edges and one just past the
    limit), taken in either order: the same bits, and the plain version's
    result to summation order."""
    indptr, indices = _graph(seed=5, N=300, hub=1000, max_deg=12)
    h = _h(indptr.numel() - 1, 24, dtype, seed=6)
    heavy = tgather.csr_plan(indptr, indices.numel()).rows[:2].tolist()
    for mean in (True, False):
        a = kernel_model(h, indptr, indices, mean, heavy)
        b = kernel_model(h, indptr, indices, mean, heavy[::-1])
        assert torch.equal(a, b)
        _close(a, _oracle(h, indptr, indices, mean), dtype)
        plain = tgather.gather_mean_csr_plain(h, indptr, indices, mean)
        _close(plain, a.double().numpy(), dtype)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call",
    [
        lambda: tgather.gather_mean_csr(_meta(5, 8), _meta(6, dtype=torch.int64), _meta(9, dtype=torch.int32)),
        lambda: tgather.csr_plan(_meta(6, dtype=torch.int64), 9),
    ],
    ids=["gather_mean_csr", "csr_plan"],
)
def test_tensors_off_the_cpu_never_take_the_plain_version(call):
    with pytest.raises(ValueError):
        call()
    assert tgather.gather_mean_csr.launches == 0 and tgather.csr_plan.launches == 0


_IP = torch.tensor([0, 2, 3, 3, 5], dtype=torch.int64)
_IX = torch.tensor([0, 1, 2, 3, 1], dtype=torch.int32)


@pytest.mark.parametrize(
    "h,indptr,indices",
    [
        (torch.zeros(8, 4).T, _IP, _IX),
        (torch.zeros(4, 8, dtype=torch.float16), _IP, _IX),
        (torch.zeros(4, 8), _IP, _IX.long()),
        (torch.zeros(4, 8), _IP, torch.zeros(5, 2, dtype=torch.int32)[:, 0]),
        (torch.zeros(4, 8), _IP[:-1], _IX),
        (torch.zeros(3, 8), _IP, _IX),
        (torch.zeros(4, 8), _IP.int(), _IX),
    ],
    ids=["h_strided", "h_float16", "indices_int64", "indices_strided", "indptr_short", "indptr_long",
         "indptr_int32"],
)
def test_each_memory_safety_check_raises_value_error(h, indptr, indices):
    with pytest.raises(ValueError):
        tgather._check_csr(h, indptr, indices, -1)


def test_the_checks_pass_a_valid_walk():
    tgather._check_csr(torch.zeros(4, 8), _IP, _IX, -1)


def test_the_constants_mirror_the_kernels_source():
    """The light limit and the heavy block's warps as csrc/gather.cu sets
    them (the library's light limit is also checked when it loads)."""
    import re

    src = (tgather.build.CSRC_DIR / "gather.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kCsrLightMax") == LIGHT
    assert const("kCsrHeavyThreads") // 32 == HEAVY_WARPS
