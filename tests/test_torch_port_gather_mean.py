"""K3 redesigned: the slot transpose and the gather-form backward as plain
versions against a numpy oracle and the JAX package, the first layer's
k-major mean (the CPU path of a dedup-free block) against JAX's, and the
launch path's contract.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against these plain versions.  Tolerances: f32 to 1e-6 where only the
summation order differs; 1e-5 against the Pallas kernel in interpret mode
(its own order of a bf16-free f32 sum over a padded table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dist_gnn_tpu import sampler as jsampler
from dist_gnn_tpu.models.sage import SAGE as JSAGE
from dist_gnn_tpu.ops import gather_pallas as jgp
from dist_gnn_tpu.ops import spmm as jspmm
from dist_gnn_tpu_torch.models import SAGE as TSAGE
from dist_gnn_tpu_torch.models import sage as tsage
from dist_gnn_tpu_torch.ops import gather as tgather
from dist_gnn_tpu_torch.sampler import Block

torch.set_num_threads(1)


def _slot_table(cap, S, k, seed):
    """Slots with duplicates within a row (row 3) and across rows (column
    0 names row 1 from every row), rows 0 and 1 all masked, and source rows
    no slot names (cap above S*k, or rows left out)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(2, cap, (S, k)).astype(np.int32)
    slots[:, 0] = 1
    slots[3, :3] = slots[3, 3]
    mask = rng.random((S, k)) < 0.7
    mask[:2] = False
    mask[3, :4] = True
    mask[4:, 0] = True
    return slots, mask


def _oracle_transpose(slots, mask, cap):
    """Each source row's valid flat slots s*k + j in increasing order."""
    S, k = slots.shape
    lists = [[] for _ in range(cap)]
    for s in range(S):
        for j in range(k):
            if mask[s, j]:
                lists[slots[s, j]].append(s * k + j)
    return lists


# ---- the slot transpose ---------------------------------------------------


@pytest.mark.parametrize("cap,S,k", [(30, 12, 5), (200, 40, 7), (9, 16, 15)])
def test_slot_transpose_plain_matches_numpy_oracle(cap, S, k):
    slots, mask = _slot_table(cap, S, k, cap + k)
    tr = tgather.slot_transpose_plain(torch.from_numpy(slots), torch.from_numpy(mask), cap)
    assert tr.offsets.dtype == tr.entries.dtype == torch.int32
    assert tr.offsets.shape == (cap + 1,) and tr.entries.shape == (S * k,)
    want = _oracle_transpose(slots, mask, cap)
    assert np.array_equal(np.diff(tr.offsets.numpy()), [len(x) for x in want])
    off = tr.offsets.numpy()
    got = [tr.entries.numpy()[off[r] : off[r + 1]].tolist() for r in range(cap)]
    assert got == want  # in increasing flat index, as the backward sums
    assert (tr.entries.numpy()[off[-1] :] == -1).all()


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    cap=st.integers(1, 40),
    S=st.integers(0, 20),
    k=st.integers(1, 9),
    seed=st.integers(0, 2**16),
    p_valid=st.floats(0.0, 1.0),
)
def test_slot_transpose_plain_properties(cap, S, k, seed, p_valid):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, cap, (S, k)).astype(np.int32)
    mask = rng.random((S, k)) < p_valid
    tr = tgather.slot_transpose_plain(torch.from_numpy(slots), torch.from_numpy(mask), cap)
    off = tr.offsets.numpy().astype(np.int64)
    assert off[0] == 0 and (np.diff(off) >= 0).all() and off[-1] == mask.sum()
    seen = np.zeros(S * k, np.int64)
    for r in range(cap):
        for e in tr.entries.numpy()[off[r] : off[r + 1]]:
            s, j = divmod(int(e), k)
            assert mask[s, j] and slots[s, j] == r  # masked slots never appear
            seen[e] += 1
    assert (seen == mask.reshape(-1)).all()  # every valid (s, j) exactly once


def test_slot_transpose_wrapper_on_cpu_is_the_plain_version():
    slots, mask = _slot_table(50, 20, 6, 3)
    ts, tm = torch.from_numpy(slots), torch.from_numpy(mask)
    got, want = tgather.slot_transpose(ts, tm, 50), tgather.slot_transpose_plain(ts, tm, 50)
    assert torch.equal(got.offsets, want.offsets) and torch.equal(got.entries, want.entries)
    assert tgather.slot_transpose.launches == 0


# ---- the gather-form backward -----------------------------------------------


@pytest.mark.parametrize("cap,S,k,F", [(30, 12, 5, 8), (200, 40, 7, 37), (9, 16, 15, 3)])
def test_csr_backward_matches_jax_grad_and_the_scatter_plain(cap, S, k, F):
    slots, mask = _slot_table(cap, S, k, S + F)
    rng = np.random.default_rng(F)
    h = rng.standard_normal((cap, F)).astype(np.float32)
    d_out = rng.standard_normal((S, F)).astype(np.float32)
    ref = jax.grad(
        lambda x: jnp.sum(jspmm.gather_mean(x, jnp.asarray(slots), jnp.asarray(mask)) * d_out)
    )(jnp.asarray(h))
    ts, tm, td = torch.from_numpy(slots), torch.from_numpy(mask), torch.from_numpy(d_out)
    got = tgather.gather_mean_bwd_csr_plain(td, tm, tgather.slot_transpose_plain(ts, tm, cap), cap)
    assert got.shape == (cap, F) and got.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgather.gather_mean_bwd_plain(td, ts, tm, cap).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-6)
    named = np.zeros(cap, bool)
    named[slots[mask]] = True
    assert (got.numpy()[~named] == 0).all()  # rows no slot names


def test_csr_backward_does_not_depend_on_the_order_within_a_list():
    """The card fills each list in its atomics' order; the sum must not
    follow it."""
    cap, S, k = 12, 30, 6
    slots, mask = _slot_table(cap, S, k, 5)
    ts, tm = torch.from_numpy(slots), torch.from_numpy(mask)
    d_out = torch.from_numpy(np.random.default_rng(0).standard_normal((S, 16)).astype(np.float32) * 1e3)
    tr = tgather.slot_transpose_plain(ts, tm, cap)
    shuffled = tr.entries.clone()
    off = tr.offsets.tolist()
    for r in range(cap):
        shuffled[off[r] : off[r + 1]] = shuffled[off[r] : off[r + 1]].flip(0)
    assert not torch.equal(shuffled, tr.entries)
    a = tgather.gather_mean_bwd_csr_plain(d_out, tm, tr, cap)
    b = tgather.gather_mean_bwd_csr_plain(d_out, tm, tgather.SlotTranspose(tr.offsets, shuffled), cap)
    assert torch.equal(a, b)


def test_csr_backward_rounds_once_to_d_outs_dtype():
    cap, S, k = 40, 20, 6
    slots, mask = _slot_table(cap, S, k, 9)
    ts, tm = torch.from_numpy(slots), torch.from_numpy(mask)
    d_out = torch.from_numpy(np.random.default_rng(1).standard_normal((S, 8)).astype(np.float32))
    tr = tgather.slot_transpose_plain(ts, tm, cap)
    d16 = d_out.to(torch.bfloat16)
    got = tgather.gather_mean_bwd_csr_plain(d16, tm, tr, cap)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tgather.gather_mean_bwd_csr_plain(d16.float(), tm, tr, cap).to(torch.bfloat16))


# ---- the k-major mean of a dedup-free block --------------------------------


def _kmajor_block(S, k, F, seed):
    """A dedup-free k-major block (``sampler._no_dedup_block``): slot j of
    row i is frontier row S + j*S + i; rows 0 and 1 all masked."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((S * (k + 1), F)).astype(np.float32)
    mask = rng.random((S, k)) < 0.7
    mask[:2] = False
    slots = np.where(mask, S + np.arange(k)[None, :] * S + np.arange(S)[:, None], 0).astype(np.int32)
    n = S * (k + 1)
    block = Block(seeds=torch.zeros(S, dtype=torch.int32), seed_mask=torch.ones(S, dtype=torch.bool),
                  frontier=torch.zeros(n, dtype=torch.int32), frontier_mask=torch.ones(n, dtype=torch.bool),
                  num_frontier=torch.tensor(n, dtype=torch.int32), neigh_slots=torch.from_numpy(slots),
                  neigh_mask=torch.from_numpy(mask))
    return h, slots, mask, block


@pytest.mark.parametrize("S,k,F", [(12, 5, 8), (33, 15, 37)])
def test_contiguous_mean_matches_jax_reshape_sum(S, k, F):
    """JAX's reshape-sum (``dist_gnn_tpu/models/sage.py:107-116``), run as a
    one-layer SAGE whose neighbour weight is the identity and whose self
    weight and bias are 0, so its output is the layer's h_mean."""
    h, slots, mask, block = _kmajor_block(S, k, F, S + k)
    jm = JSAGE(F, F, F, 1)
    params = {"layer0": {"w_self": jnp.zeros((F, F)), "w_neigh": jnp.eye(F), "b": jnp.zeros(F)}}
    n = S * (k + 1)
    jblock = jsampler.Block(
        seeds=jnp.zeros(S, jnp.int32), seed_mask=jnp.ones(S, bool), frontier=jnp.zeros(n, jnp.int32),
        frontier_mask=jnp.ones(n, bool), num_frontier=jnp.asarray(n, jnp.int32),
        neigh_slots=jnp.asarray(slots), neigh_mask=jnp.asarray(mask),
    )
    ref = jm.apply(params, (jblock,), jnp.asarray(h), contiguous_first=True)
    got = tsage.contiguous_mean(torch.from_numpy(h), block)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-6, atol=1e-6)
    assert (got[:2] == 0).all()


def test_contiguous_mean_matches_the_pallas_gather_mean_and_k3_on_the_same_block():
    """The reshape-sum, the Pallas K3 (interpret mode) and the port's K3 on
    the block's explicit slots agree: the card runs the last on this layer."""
    h, slots, mask, block = _kmajor_block(16, 5, 128, 2)  # the Pallas kernel needs F % 128 == 0
    ref = jgp.gather_mean(jnp.asarray(h), jnp.asarray(slots), jnp.asarray(mask))
    got = tsage.contiguous_mean(torch.from_numpy(h), block)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-5, atol=1e-5)
    k3 = tgather.gather_mean(torch.from_numpy(h), block.neigh_slots, block.neigh_mask)
    np.testing.assert_allclose(k3.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sage_first_layer_is_the_same_by_reshape_and_by_slots(dtype):
    """On the CPU the model takes the reshape-sum for a dedup-free first
    layer, on the card K3 on the block's slots: both give one output."""
    S, k, F = 10, 4, 6
    h, _, _, block = _kmajor_block(S, k, F, 11)
    model = TSAGE(F, 5, 3, 1, compute_dtype=None if dtype == torch.float32 else dtype, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(h)
    by_reshape = model((block,), x, contiguous_first=True)
    by_slots = model((block,), x, contiguous_first=False)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(by_reshape.float(), by_slots.float(), rtol=tol, atol=tol)


# ---- the launch path ------------------------------------------------------


def test_gather_mean_without_a_gradient_skips_the_autograd_node():
    h = torch.randn(30, 8)
    slots, mask = (torch.from_numpy(a) for a in _slot_table(30, 10, 4, 0))
    assert tgather.gather_mean(h, slots, mask).grad_fn is None
    hg = h.clone().requires_grad_(True)
    assert tgather.gather_mean(hg, slots, mask).grad_fn is not None
    with torch.no_grad():
        assert tgather.gather_mean(hg, slots, mask).grad_fn is None
    assert tgather.gather_mean.launches == tgather.slot_transpose.launches == 0


def test_stream_calls_are_those_of_a_cuda_build():
    """``kernels.launch.stream_of`` calls ``torch._C``'s raw current-device
    and stream calls with no fallback: every CUDA build of PyTorch must have
    them, and a CPU-only build, where no CUDA tensor reaches ``stream_of``,
    has neither."""
    have = [hasattr(torch._C, name) for name in ("_cuda_getDevice", "_cuda_getCurrentRawStream")]
    assert have == [torch.backends.cuda.is_built()] * 2


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call",
    [
        lambda: tgather.gather_mean(_meta(30, 8), _meta(4, 3, dtype=torch.int32), _meta(4, 3, dtype=torch.bool)),
        lambda: tgather.gather_mean(_meta(30, 8).requires_grad_(True), _meta(4, 3, dtype=torch.int32),
                                    _meta(4, 3, dtype=torch.bool)),
        lambda: tgather.slot_transpose(_meta(4, 3, dtype=torch.int32), _meta(4, 3, dtype=torch.bool), 30),
        lambda: tgather.gather_mean_bwd(_meta(4, 8), _meta(4, 3, dtype=torch.int32),
                                        _meta(4, 3, dtype=torch.bool), 30),
    ],
    ids=["gather_mean", "gather_mean_grad", "slot_transpose", "gather_mean_bwd"],
)
def test_tensors_off_the_cpu_never_take_the_plain_version(call):
    """A 'meta' tensor is not on the CPU and not on a CUDA device: each
    wrapper must raise, not fall back."""
    wrappers = (tgather.gather_mean, tgather.slot_transpose, tgather.gather_mean_bwd)
    with pytest.raises(ValueError):
        call()
    assert [f.launches for f in wrappers] == [0, 0, 0]


_I32, _B = torch.int32, torch.bool


@pytest.mark.parametrize(
    "call",
    [
        lambda: tgather._check_rows(torch.zeros(4, 8, dtype=torch.float16), "h"),
        lambda: tgather._check_rows(torch.zeros(4, 8, 2), "h"),
        lambda: tgather._check_rows(torch.zeros(8, 4).T, "h"),
        lambda: tgather._check_slots(torch.zeros(4, 3, dtype=torch.int64), torch.ones(4, 3, dtype=_B),
                                     -1),
        lambda: tgather._check_slots(torch.zeros(3, 4, dtype=_I32).T, torch.ones(4, 3, dtype=_B),
                                     -1),
        lambda: tgather._check_slots(torch.zeros(4, 3, dtype=_I32), torch.ones(4, 3, dtype=torch.uint8),
                                     -1),
        lambda: tgather._check_slots(torch.zeros(4, 3, dtype=_I32), torch.ones(4, 2, dtype=_B),
                                     -1),
        lambda: tgather._check_slots(torch.zeros(4, 3, dtype=_I32), torch.ones(4, 3, dtype=_B), 0),
        lambda: tgather._check_d_out(torch.zeros(4, 8), torch.ones(4, 3, dtype=_B)),
    ],
    ids=["h_dtype", "h_3d", "h_strided", "slots_int64", "slots_strided", "mask_uint8", "mask_shape",
         "slots_device", "d_out_not_cuda"],
)
def test_each_memory_safety_check_raises_value_error(call):
    with pytest.raises(ValueError):
        call()


# ---- the transpose's order of work on the card --------------------------------

_SCAN_ROWS = 1024  # csrc/gather.cu kScanThreads: the rows a scan block takes
_LIGHT_MAX = 32  # csrc/gather.cu kLightMax


def transpose_model(slots, mask, cap, range_rows, rng):
    """The slot transpose as csrc/gather.cu builds it: count, one atomic per
    valid slot, in an order the scheduler chooses (``rng``); the rows
    scanned in ranges of ``range_rows`` (one block each, finishing in any
    order), the range sums scanned after; fill, one atomicSub per valid
    slot in another order, whose old value places the slot in its row's
    list.  Returns offsets, entries, the heavy rows, the atomics made, and
    the counts left after the fill (all 0)."""
    S, k = slots.shape
    n = S * k
    rows = np.clip(slots.reshape(-1).astype(np.int64), 0, cap - 1)
    valid = np.nonzero(mask.reshape(-1))[0]
    counts = np.zeros(cap, np.int64)
    atomics = 0
    for e in rng.permutation(valid):
        counts[rows[e]] += 1
        atomics += 1
    local = np.zeros(cap, np.int64)
    ranges = (cap + range_rows - 1) // range_rows
    sums = np.zeros(ranges, np.int64)
    for g in rng.permutation(ranges):
        lo, hi = g * range_rows, min(g * range_rows + range_rows, cap)
        local[lo:hi] = np.cumsum(counts[lo:hi]) - counts[lo:hi]
        sums[g] = counts[lo:hi].sum()
    prefix = np.cumsum(sums) - sums  # the last block's scan of the range sums
    offsets = np.zeros(cap + 1, np.int64)
    offsets[:cap] = local + prefix[np.arange(cap) // range_rows]
    offsets[cap] = sums.sum()
    heavy = np.nonzero(np.diff(offsets) > _LIGHT_MAX)[0]
    entries = np.full(n, -1, np.int64)
    left = counts.copy()
    for e in rng.permutation(valid):
        r = rows[e]
        left[r] -= 1  # atomicSub returns the old count: the slot takes place old - 1
        atomics += 1
        entries[offsets[r] + left[r]] = e
    return offsets, entries, heavy, atomics, left


def _hub_table(cap, S, k, seed, hub_every=7, p_valid=0.8):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, cap, (S, k)).astype(np.int32)
    slots.reshape(-1)[::hub_every] = 3  # row 3 a hub, named across many warps
    slots[2, :] = 5  # row 5 named by a whole row's lanes in one warp
    mask = rng.random((S, k)) < p_valid
    return slots, mask


@pytest.mark.parametrize(
    "cap,range_rows,ranges",
    [(700, _SCAN_ROWS, 1), (3000, _SCAN_ROWS, 3), (264 * 16, 16, 264)],
    ids=["1_range", "3_ranges", "264_ranges"],
)
@pytest.mark.parametrize("table", ["hub", "all_masked"])
def test_transpose_model_equals_plain_and_jax_grad(cap, range_rows, ranges, table):
    """Ranges of rows over G scan blocks (G = 1, 3, 264), the range sums'
    scan and one atomic per slot, in shuffled slot and block orders:
    offsets equal slot_transpose_plain's, each list is the plain list as a
    set, the counts return to 0, the hub row is a heavy row, and the
    gradient summed over the model's lists equals JAX's scatter
    gradient."""
    S, k, F = 400, 10, 6
    slots, mask = _hub_table(cap, S, k, seed=ranges)
    if table == "all_masked":
        mask[:] = False
    assert (cap + range_rows - 1) // range_rows == ranges
    ts, tm = torch.from_numpy(slots), torch.from_numpy(mask)
    want = tgather.slot_transpose_plain(ts, tm, cap)
    for order in range(2):
        offsets, entries, heavy, atomics, left = transpose_model(slots, mask, cap, range_rows,
                                                                 np.random.default_rng(order))
        np.testing.assert_array_equal(offsets, want.offsets.numpy())
        n = int(offsets[-1])
        got_sets = [sorted(entries[offsets[r] : offsets[r + 1]]) for r in range(cap)]
        want_lists = [want.entries.numpy()[offsets[r] : offsets[r + 1]].tolist() for r in range(cap)]
        assert got_sets == want_lists
        assert (left == 0).all() and (entries[n:] == -1).all()
        np.testing.assert_array_equal(heavy, np.nonzero(np.diff(want.offsets.numpy()) > _LIGHT_MAX)[0])
    if table == "all_masked":
        assert n == 0 and atomics == 0 and heavy.size == 0
        return
    flat = slots.reshape(-1)[mask.reshape(-1)]
    assert (flat == 3).sum() > _LIGHT_MAX and 3 in heavy  # the hub row is heavy
    assert atomics == 2 * flat.shape[0]
    rng = np.random.default_rng(F)
    h = rng.standard_normal((cap, F)).astype(np.float32)
    d_out = rng.standard_normal((S, F)).astype(np.float32)
    ref = jax.grad(
        lambda x: jnp.sum(jspmm.gather_mean(x, jnp.asarray(slots), jnp.asarray(mask)) * d_out)
    )(jnp.asarray(h))
    model_tr = tgather.SlotTranspose(torch.from_numpy(offsets.astype(np.int32)),
                                     torch.from_numpy(entries.astype(np.int32)))
    got = tgather.gather_mean_bwd_csr_plain(torch.from_numpy(d_out), tm, model_tr, cap)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-6, atol=1e-6)


def test_the_transpose_is_four_chained_kernels_and_no_memset():
    """The build's source: four kernels chained by programmatic dependent
    launch, each waiting for the one before, and no memset."""
    src = (tgather.build.CSRC_DIR / "gather.cu").read_text()
    body = src[src.index("int build_transpose(") : src.index("// d_h[r] = sum over row r's list")]
    assert body.count("launch_chained(") == 4 and "cudaMemsetAsync" not in body
    for kernel in ("transpose_zero_kernel", "transpose_count_kernel", "transpose_scan_kernel",
                   "transpose_fill_kernel"):
        assert kernel in body
        head = src[src.index(kernel + "(") :]
        assert head[: head.index("\n}\n")].count("wait_for_previous_grid();") == 1
    assert f"constexpr int kScanThreads = {_SCAN_ROWS};" in src and f"constexpr int kLightMax = {_LIGHT_MAX};" in src
