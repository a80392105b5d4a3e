"""Counter-based PRNG: the JAX package's uint32 hashes, bit for bit.

Counterpart of ``dist_gnn_tpu/ops/prng.py``.  Sampling and dropout are pure
functions of per-row uint32 keys, so the port and the JAX package draw the
same neighbours and drop the same activations from the same keys.  The
keys themselves come from a ``torch.Generator`` here (:func:`random_keys`)
and from threefry there; tests inject JAX's keys to compare the two.

torch has no full uint32 arithmetic (``>>`` on ``torch.uint32`` is not
implemented on the CPU), so every value is an int64 tensor holding a
uint32 in ``[0, 2**32)``, masked with ``& 0xFFFFFFFF`` after each multiply.
The int64 product of two 32-bit values can exceed 2**63; it then wraps,
and its low 32 bits, which the mask keeps, are still the uint32 product.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF
# Walk steps of the cycle-walk and Feistel rounds: the JAX package's
# values (prng.py:23-34), which fix the permutation itself.
_WALK_STEPS = 12
_FEISTEL_ROUNDS = 8
_GOLDEN = 0x9E3779B9


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32 — a bijection on uint32, used as the universal hash."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


def hash_combine(a, b) -> torch.Tensor:
    """Order-sensitive combiner: mix(a ^ (mix(b) + golden))."""
    return mix32(_u32(a) ^ ((mix32(b) + _GOLDEN) & _M32))


def random_keys(
    generator: torch.Generator, shape: Sequence[int], device: Optional[torch.device] = None
) -> torch.Tensor:
    """Per-element uint32 keys (as int64) drawn from ``generator`` on its
    own device, then moved to ``device``."""
    bits = torch.randint(
        0, 2**32, tuple(shape), generator=generator, dtype=torch.int64,
        device=generator.device,
    )
    return bits if device is None else bits.to(device)


def _ceil_log2(d: torch.Tensor) -> torch.Tensor:
    """ceil(log2(d)) for d >= 1, elementwise; 0 for d <= 1."""
    d = _u32(d)
    v = torch.clamp(d, min=1) - 1
    bits = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        hi = v >> s
        take = hi > 0
        bits = torch.where(take, bits + s, bits)
        v = torch.where(take, hi, v)
    return torch.where(d <= 1, torch.zeros_like(bits), bits + (v > 0).to(torch.int64))


def _feistel(x, lo_bits, hi_bits, row_key) -> torch.Tensor:
    """One pass of an (optionally unbalanced) Feistel network on a
    ``2**(lo_bits + hi_bits)`` domain; widths vary per element.  Each round
    maps (a, b) -> (b, a ^ (F(b) & mask_a)) with the widths swapping; the
    round count is even, so widths end where they began."""
    wb, wa = lo_bits, hi_bits
    b = x & ((1 << wb) - 1)
    a = (x >> wb) & ((1 << wa) - 1)
    for r in range(_FEISTEL_ROUNDS):
        f = mix32(((b * _GOLDEN) & _M32) ^ ((row_key + ((r * 0x7F4A7C15) & _M32)) & _M32))
        a, b = b, a ^ (f & ((1 << wa) - 1))
        wa, wb = wb, wa
    return (a << wb) | b


def feistel_permutation(j, domain, row_key) -> torch.Tensor:
    """A keyed pseudorandom permutation of [0, domain) evaluated at ``j``.

    ``domain`` (>= 1) and ``row_key`` broadcast against ``j``.  Distinct
    j < domain map to distinct outputs, except through the cycle-walk's
    rare ``y % domain`` fallback (probability < 2**-12 per element), which
    can collide.  Returns int32."""
    j = _u32(j)
    d = torch.clamp(_u32(domain), min=1)
    row_key = _u32(row_key)
    # walked domain = 2**bits < 2d (unbalanced split: lo gets the odd bit)
    bits = torch.clamp(_ceil_log2(d), min=2)
    lo_bits = (bits + 1) >> 1
    hi_bits = bits - lo_bits

    y = _feistel(j, lo_bits, hi_bits, row_key)
    for _ in range(_WALK_STEPS):
        y = torch.where(y < d, y, _feistel(y, lo_bits, hi_bits, row_key))
    y = torch.where(y < d, y, y % d)
    return y.to(torch.int32)


def uniform_mod(bits, d) -> torch.Tensor:
    """bits % d with d clamped >= 1 (with-replacement draws).  Returns int32."""
    return (_u32(bits) % torch.clamp(_u32(d), min=1)).to(torch.int32)


def bits_to_uniform(bits) -> torch.Tensor:
    """uint32 → float32 uniform in (0, 1): (bits >> 8) * 2**-24, nudged off 0."""
    u = (_u32(bits) >> 8).to(torch.float32) * (2.0**-24)
    return torch.clamp(u, min=2.0**-25)


def dropout_keep(row_keys: torch.Tensor, shape: Sequence[int], keep_prob: float) -> torch.Tensor:
    """Dropout mask [S, H] (True = keep) from one uint32 key per row:
    ``mix32(row ^ col * 0x9E3779B9)`` per element, kept where its uniform
    is below ``keep_prob``.  The JAX package draws the [S] row keys with
    threefry inside ``dropout_keep``; here they are an argument, drawn from
    a ``torch.Generator`` (:func:`random_keys`) or injected by a test."""
    S, H = shape
    if row_keys.shape != (S,):
        raise ValueError(f"need {S} row keys, got shape {tuple(row_keys.shape)}")
    col = torch.arange(H, dtype=torch.int64, device=row_keys.device)
    bits = mix32(_u32(row_keys)[:, None] ^ ((col * _GOLDEN) & _M32))
    return bits_to_uniform(bits) < keep_prob
