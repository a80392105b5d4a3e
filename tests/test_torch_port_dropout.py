"""K10, dropout as one kernel (``ops/dropout.py``, ``csrc/sampling.cu``
``dg_dropout``): its plain version against the ``where`` form the models
used before it, a numpy model of the kernel's per-element arithmetic
against ``prng.dropout_keep`` and JAX's ``dropout_keep``, the constants the
source shares with ``prng.py``, the wrapper's contract, and its launch
path (the autograd Function, forward and backward) through a fake library
that runs the numpy model on the tensors' memory.

The CUDA kernel runs only on the card, where ``chip_smoke.py``'s dropout
phase holds it to the ``where`` form bit for bit.  On the card PyTorch
divides by a Python scalar by multiplying by the f32 reciprocal of the
scalar's f32 value, which the kernel does too; on the CPU PyTorch divides,
so the fake launch path is held bit for bit to the plain version at rate
0.5 (the reciprocal 2 is exact) and to ``h * reciprocal`` at other rates.
"""

import ctypes
import inspect
import re

import jax
import numpy as np
import pytest
import torch

from dist_gnn_tpu.ops import prng as jprng
from dist_gnn_tpu_torch.graph import Graph
from dist_gnn_tpu_torch.kernels import build
from dist_gnn_tpu_torch.models import sage as sage_mod
from dist_gnn_tpu_torch.models.gat import GAT
from dist_gnn_tpu_torch.models.sage import SAGE
from dist_gnn_tpu_torch.models.transformer import GraphTransformer
from dist_gnn_tpu_torch.ops import dropout as drop_ops
from dist_gnn_tpu_torch.ops import prng
from dist_gnn_tpu_torch.sampler import sample_blocks
from dist_gnn_tpu_torch.utils import trace

torch.set_num_threads(1)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
RATES = (0.5, 0.3, 0.1)


def _where_form(h, row_keys, rate):
    """The models' dropout before K10 (``models/sage.py`` ``_dropout``)."""
    keep = prng.dropout_keep(row_keys, h.shape, 1.0 - rate)
    return torch.where(keep, h / (1.0 - rate), 0)


def _inputs(S, H, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(S, H, generator=gen).to(dtype)
    keys = prng.random_keys(gen, (S,))
    return h, keys, torch.randn(S, H, generator=gen).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# ---- the model: csrc/sampling.cu's K10, element by element ------------------


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def k10_keep(keys_u32, H, keep_prob):
    """drop_keep over [S, H]: native uint32 arithmetic that wraps, the
    ``>> 8``, the float conversion and scale, the 2^-25 floor, the compare
    with the f32 keep probability."""
    col = np.arange(H, dtype=np.uint32)
    bits = _mix32(keys_u32[:, None] ^ (col * np.uint32(0x9E3779B9)))
    u = np.maximum((bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24), np.float32(2.0**-25))
    return u < np.float32(keep_prob)


def k10_out(h, keys_u32, keep_prob, scale):
    """K10's output: h * scale in f32 where kept, rounded to h's dtype; 0
    where dropped."""
    keep = torch.from_numpy(k10_keep(keys_u32, h.shape[1], keep_prob))
    return torch.where(keep, (h.float() * torch.tensor(scale, dtype=torch.float32)).to(h.dtype), 0)


def _scale(rate):
    keep = np.float32(1.0 - rate)
    return float(keep), float(np.float32(1.0) / keep)


# ---- the plain version: the where form, bit for bit -------------------------


SHAPES = pytest.mark.parametrize("S", [0, 1, 33])
WIDTHS = pytest.mark.parametrize("H", [17, 47, 256, 512])
RATE = pytest.mark.parametrize("rate", RATES)
DTYPE = pytest.mark.parametrize("dt", list(DTYPES))


@DTYPE
@WIDTHS
@RATE
@SHAPES
def test_plain_version_equals_the_where_form(dt, H, rate, S):
    h, keys, _ = _inputs(S, H, DTYPES[dt], seed=S + H)
    out = drop_ops.dropout_plain(h, keys, rate)
    assert out.dtype == h.dtype and out.shape == h.shape
    assert torch.equal(_bits(out), _bits(_where_form(h, keys, rate)))
    # dropout() takes the plain version for CPU tensors, and launches nothing
    before = drop_ops.dropout.launches
    assert torch.equal(_bits(drop_ops.dropout(h, keys, rate)), _bits(out))
    assert drop_ops.dropout.launches == before


@DTYPE
@WIDTHS
@RATE
@SHAPES
def test_plain_gradient_equals_the_where_forms(dt, H, rate, S):
    h, keys, g = _inputs(S, H, DTYPES[dt], seed=100 + S + H)
    grads = []
    for fn in (drop_ops.dropout_plain, _where_form):
        x = h.clone().requires_grad_()
        fn(x, keys, rate).backward(g)
        grads.append(x.grad)
    assert grads[0].dtype == h.dtype
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))


# ---- the numpy model against the PRNG ---------------------------------------


@pytest.mark.parametrize("rate", (0.5, 0.3, 0.1, 0.0))
@pytest.mark.parametrize("H", [1, 17, 256, 512])
def test_the_kernels_arithmetic_equals_dropout_keep(rate, H):
    """Native uint32 hashing with a float compare keeps what the int64
    emulation keeps, on random keys and the extremes 0 and 2^32 - 1."""
    gen = torch.Generator().manual_seed(H)
    keys = torch.cat([torch.tensor([0, 2**32 - 1, 1, 0x9E3779B9]), prng.random_keys(gen, (200,))])
    want = prng.dropout_keep(keys, (keys.numel(), H), 1.0 - rate).numpy()
    got = k10_keep(keys.numpy().astype(np.uint32), H, 1.0 - rate)
    assert np.array_equal(got, want)
    if rate == 0.0:
        assert got.all()


@pytest.mark.parametrize("rate", (0.5, 0.3))
def test_the_kernels_arithmetic_equals_jaxs_dropout_keep(rate):
    """JAX's ``dropout_keep`` draws its row keys with threefry and hashes in
    uint32: the model on those row keys keeps the same elements."""
    key = jax.random.PRNGKey(7)
    S, H = 96, 100
    want = np.asarray(jprng.dropout_keep(key, (S, H), 1.0 - rate))
    rows = np.asarray(jprng.random_keys(key, (S,)))
    assert np.array_equal(k10_keep(rows, H, 1.0 - rate), want)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_the_model_at_rate_one_half_equals_the_plain_version(dt):
    """At rate 0.5 the reciprocal is 2, exact: the kernel's multiply and the
    CPU's divide give the same bits."""
    h, keys, _ = _inputs(64, 256, DTYPES[dt], seed=3)
    keep, scale = _scale(0.5)
    assert scale == 2.0
    got = k10_out(h, keys.numpy().astype(np.uint32), keep, scale)
    assert torch.equal(_bits(got), _bits(drop_ops.dropout_plain(h, keys, 0.5)))


# ---- the source ---------------------------------------------------------------


def test_the_source_mirrors_prng():
    src = (build.CSRC_DIR / "sampling.cu").read_text()
    assert "sampling" in build.SOURCES
    assert f"constexpr uint32_t kGolden = 0x{prng._GOLDEN:X}u;" in src
    mix = src[src.index("uint32_t mix32(uint32_t x)"):]
    mix = mix[: mix.index("}")]
    steps = re.findall(r"x (\^=|\*=) ([^;]+);", mix)
    assert steps == [("^=", "x >> 16"), ("*=", "0x85EBCA6Bu"), ("^=", "x >> 13"), ("*=", "0xC2B2AE35u"),
                     ("^=", "x >> 16")]
    # prng.py's mix32: the same shifts and multipliers, in the same order
    py = inspect.getsource(prng.mix32)
    assert re.findall(r"x >> (\d+)", py) == ["16", "13", "16"]
    assert [int(c, 16) for c in re.findall(r"\* (0x[0-9A-F]+)", py)] == [0x85EBCA6B, 0xC2B2AE35]
    unit = float(re.search(r"constexpr float kUnit = ([0-9.e+-]+)f;", src).group(1))
    floor = float(re.search(r"constexpr float kFloor = ([0-9.e+-]+)f;", src).group(1))
    assert (unit, floor) == (2.0**-24, 2.0**-25)
    assert "mix32(key ^ (col * kGolden))" in src
    assert "fmaxf((float)(bits >> 8) * kUnit, kFloor) < keep_prob" in src
    assert "return VEC_BYTES // dtype.itemsize" in (build.PKG_DIR / "ops" / "dropout.py").read_text()
    assert f"vec != {drop_ops.VEC_BYTES} / (int)sizeof(T)" in src
    assert f"constexpr int64_t kMaxDropoutElems = (int64_t)1 << {drop_ops.MAX_ELEMS.bit_length() - 1};" in src
    assert "S > kMaxDropoutElems / H" in src
    assert "int dg_dropout(" in src[src.index('extern "C"'):]


# ---- the wrapper --------------------------------------------------------------


@pytest.mark.parametrize("case", ["key_count", "key_rank", "key_dtype", "key_contiguous", "dtype_f16",
                                  "dtype_f64", "rank", "contiguous", "rate_one", "rate_negative",
                                  "past_32_bit_indices"])
def test_the_wrapper_checks_its_inputs(case):
    meta = dict(device="meta")
    S, H = 8, 16
    h = torch.empty(S, H, dtype=torch.bfloat16, **meta)
    keys = torch.empty(S, dtype=torch.int64, **meta)
    assert drop_ops._check_layout(h, keys, 0.5) == (S, H)
    bad = {
        "key_count": (h, torch.empty(S + 1, dtype=torch.int64, **meta), 0.5),
        "key_rank": (h, torch.empty(S, 1, dtype=torch.int64, **meta), 0.5),
        "key_dtype": (h, torch.empty(S, dtype=torch.int32, **meta), 0.5),
        "key_contiguous": (h, torch.empty(2 * S, dtype=torch.int64, **meta)[::2], 0.5),
        "dtype_f16": (h.half(), keys, 0.5),
        "dtype_f64": (h.double(), keys, 0.5),
        "rank": (h.reshape(S * H), keys, 0.5),
        "contiguous": (torch.empty(H, S, dtype=torch.bfloat16, **meta).T, keys, 0.5),
        "rate_one": (h, keys, 1.0),
        "rate_negative": (h, keys, -0.1),
        "past_32_bit_indices": (torch.empty(2**16 + 1, 2**15, dtype=torch.bfloat16, **meta),
                                torch.empty(2**16 + 1, dtype=torch.int64, **meta), 0.5),
    }[case]
    with pytest.raises(ValueError):
        drop_ops._check_layout(*bad)


def test_a_tensor_off_the_cpu_launches_or_raises():
    """A 'meta' tensor is not a CUDA tensor: the wrapper refuses it before
    any launch, and never falls back to the plain version."""
    h = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
    keys = torch.empty(8, dtype=torch.int64, device="meta")
    before = drop_ops.dropout.launches
    with pytest.raises(ValueError, match="CUDA"):
        drop_ops.dropout(h, keys, 0.5)
    assert drop_ops.dropout.launches == before


@pytest.mark.parametrize("H,dt,ptrs,want", [
    (256, torch.bfloat16, (0, 4096), 8), (512, torch.float32, (0, 16), 4), (4, torch.float32, (32,), 4),
    (100, torch.bfloat16, (0,), 1), (47, torch.float32, (0,), 1), (17, torch.bfloat16, (0,), 1),
    (64, torch.float32, (4, 0), 1), (64, torch.bfloat16, (0, 8), 1)])
def test_the_width_and_alignment_pick_the_path(H, dt, ptrs, want):
    assert drop_ops.vector_width(H, dt, *ptrs) == want


# ---- the launch path, through a fake library -----------------------------------


def _as_tensor(ptr, n, dtype):
    if dtype == torch.bfloat16:
        raw = np.ctypeslib.as_array((ctypes.c_uint16 * n).from_address(ptr))
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)))


class FakeLib:
    """``dg_dropout`` as the numpy model, on the memory the pointers name."""

    def __init__(self):
        self.calls = []

    def dg_dropout(self, h_ptr, keys_ptr, out_ptr, S, H, code, vec, keep, scale, stream):
        dtype = {0: torch.float32, 1: torch.bfloat16}[code]
        self.calls.append((S, H, code, vec, keep, scale, stream))
        h = _as_tensor(h_ptr, S * H, dtype).reshape(S, H)
        keys = np.ctypeslib.as_array((ctypes.c_int64 * S).from_address(keys_ptr)).astype(np.uint32)
        _as_tensor(out_ptr, S * H, dtype).reshape(S, H).copy_(k10_out(h, keys, keep, scale))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The launch path on CPU tensors: the device check patched out, the
    fake library, a stream number."""
    lib = FakeLib()
    monkeypatch.setattr(drop_ops, "_check", drop_ops._check_layout)
    monkeypatch.setattr(drop_ops, "_lib", lambda: lib)
    monkeypatch.setattr(drop_ops, "stream_of", lambda t: 7)
    return lib


@pytest.mark.parametrize("S,H,dt", [(40, 256, "bf16"), (33, 512, "f32"), (21, 47, "f32"), (19, 17, "bf16")])
@pytest.mark.parametrize("rate", (0.5, 0.3))
def test_the_function_launches_forward_and_backward(fake_launch, S, H, dt, rate):
    """One launch forward and one backward, on the same keys; only the keys
    are saved; the output and gradient are K10's (at rate 0.5 the plain
    version's too, bit for bit)."""
    h, keys, g = _inputs(S, H, DTYPES[dt], seed=S)
    x = h.clone().requires_grad_()
    before = drop_ops.dropout.launches
    out = drop_ops._Dropout.apply(x, keys, rate)
    assert drop_ops.dropout.launches == before + 1
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == keys.data_ptr()
    out.backward(g)
    assert drop_ops.dropout.launches == before + 2
    keep, scale = _scale(rate)
    vec = drop_ops.vector_width(H, h.dtype, 0)
    assert fake_launch.calls == [(S, H, 0 if dt == "f32" else 1, vec, keep, scale, 7)] * 2
    k = keys.numpy().astype(np.uint32)
    assert torch.equal(_bits(out), _bits(k10_out(h, k, keep, scale)))
    assert torch.equal(_bits(x.grad), _bits(k10_out(g, k, keep, scale)))
    if rate == 0.5:
        y = h.clone().requires_grad_()
        ref = _where_form(y, keys, rate)
        ref.backward(g)
        assert torch.equal(_bits(out), _bits(ref)) and torch.equal(_bits(x.grad), _bits(y.grad))
    drop_ops.dropout.launches = before


def test_an_empty_input_launches_nothing(fake_launch):
    before = drop_ops.dropout.launches
    out = drop_ops._Dropout.apply(torch.empty(0, 256, dtype=torch.bfloat16), torch.empty(0, dtype=torch.int64), 0.5)
    assert out.shape == (0, 256) and fake_launch.calls == [] and drop_ops.dropout.launches == before


def test_a_failed_launch_raises(monkeypatch):
    class Lib:
        def dg_dropout(self, *args):
            return 1

    monkeypatch.setattr(drop_ops, "_check", drop_ops._check_layout)
    monkeypatch.setattr(drop_ops, "_lib", Lib)
    monkeypatch.setattr(drop_ops, "stream_of", lambda t: 0)
    h, keys, _ = _inputs(4, 16, torch.float32)
    before = drop_ops.dropout.launches
    with pytest.raises(RuntimeError, match="dropout"):
        drop_ops._Dropout.apply(h, keys, 0.5)
    assert drop_ops.dropout.launches == before


# ---- the models ------------------------------------------------------------------


N, F, C = 90, 12, 5
FANOUT = (3, 2)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 6, N)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int64))
    indices = torch.from_numpy(rng.integers(0, N, int(indptr[-1])).astype(np.int32))
    g = Graph(indptr=indptr, indices=indices, probs=None, num_nodes=N, num_edges=indices.numel(),
              max_degree=int(deg.max()))
    gen = torch.Generator().manual_seed(5)
    seeds = torch.randperm(N, generator=gen)[:12].to(torch.int32)
    mask = torch.ones(12, dtype=torch.bool)
    blocks, _ = sample_blocks(g, seeds, mask, FANOUT, False, gen, dedup_last=False)
    blocks = tuple(reversed(blocks))
    feats = torch.randn(N, F, generator=gen)
    x = feats[torch.where(blocks[0].frontier_mask, blocks[0].frontier, 0).long()]
    drops = [prng.random_keys(gen, (b.num_dst,)) for b in blocks[:-1]]
    return blocks, x, drops


MODELS = {
    "sage_bf16": lambda: SAGE(F, 16, C, 2, compute_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(1),
                              device="cpu"),
    "gat_f32": lambda: GAT(F, 8, C, 2, num_heads=2, generator=torch.Generator().manual_seed(2), device="cpu"),
    "transformer_f32": lambda: GraphTransformer(F, 8, C, 2, num_heads=2, generator=torch.Generator().manual_seed(3),
                                                device="cpu"),
}


def _step(model, batch):
    blocks, x, drops = batch
    model.zero_grad(set_to_none=True)
    out = model(blocks, x, train=True, rng=list(drops), contiguous_first=True)
    out.float().square().mean().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", list(MODELS))
def test_models_through_the_launch_path_equal_the_where_form(fake_launch, batch, name, monkeypatch):
    """SAGE (bf16), GAT and the transformer (f32) in train mode on injected
    keys: logits and every gradient through the Function and the fake K10
    bit-equal to the same step on the where form (the models' rate 0.5)."""
    model = MODELS[name]()
    with torch.no_grad():  # no zero start, so every path carries a gradient
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(i)))
    monkeypatch.setattr(sage_mod, "dropout", _where_form)
    out_w, grads_w = _step(model, batch)
    monkeypatch.setattr(sage_mod, "dropout", drop_ops._Dropout.apply)
    before = drop_ops.dropout.launches
    out_k, grads_k = _step(model, batch)
    assert drop_ops.dropout.launches - before == 2 * (len(FANOUT) - 1)
    assert torch.equal(_bits(out_k), _bits(out_w))
    for n in grads_w:
        assert torch.equal(_bits(grads_k[n]), _bits(grads_w[n])), n
    drop_ops.dropout.launches = before


@pytest.mark.parametrize("name", list(MODELS))
def test_dropout_elems_counts_each_dropout_layer_once(batch, name):
    blocks, x, drops = batch
    model = MODELS[name]()
    trace.drain()
    trace.enable()
    try:
        out = model(blocks, x, train=True, rng=list(drops), contiguous_first=True)
        model(blocks, x, train=False, contiguous_first=True)  # eval: no dropout
    finally:
        trace.disable()
    spans, counters, _ = trace.drain()
    widths = {"sage_bf16": 16, "gat_f32": 16, "transformer_f32": 16}[name]
    assert counters["dropout.elems"] == sum(b.num_dst * widths for b in blocks[:-1])
    assert sum(s["name"] == "forward.dropout" for s in spans) == len(blocks) - 1
    assert out.shape == (blocks[-1].num_dst, C)
