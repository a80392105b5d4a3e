"""The counter-based hashes that fix which neighbours a row key selects
and which activations a dropout key drops: a frozen copy of the
published arithmetic (murmur3's fmix32, an unbalanced Feistel network with
a cycle walk, ``(bits >> 8) * 2**-24`` uniforms), in plain torch.

Values are uint32 held in int64 tensors and masked after every multiply;
the low 32 bits of a wrapped int64 product are the uint32 product.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
WALK_STEPS = 12
FEISTEL_ROUNDS = 8


def u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & M32


def mix32(x) -> torch.Tensor:
    x = u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def ceil_log2(d: torch.Tensor) -> torch.Tensor:
    """ceil(log2(d)) for d >= 1, 0 for d <= 1 (exact integer arithmetic)."""
    d = u32(d)
    v = torch.clamp(d, min=1) - 1
    bits = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        hi = v >> s
        take = hi > 0
        bits = torch.where(take, bits + s, bits)
        v = torch.where(take, hi, v)
    return torch.where(d <= 1, torch.zeros_like(bits), bits + (v > 0).to(torch.int64))


def _feistel(x, lo_bits, hi_bits, key) -> torch.Tensor:
    wb, wa = lo_bits, hi_bits
    b = x & ((1 << wb) - 1)
    a = (x >> wb) & ((1 << wa) - 1)
    for r in range(FEISTEL_ROUNDS):
        f = mix32(((b * GOLDEN) & M32) ^ ((key + ((r * 0x7F4A7C15) & M32)) & M32))
        a, b = b, a ^ (f & ((1 << wa) - 1))
        wa, wb = wb, wa
    return (a << wb) | b


def permute(j, domain, key) -> torch.Tensor:
    """The keyed permutation of [0, domain) at ``j`` (int64): a Feistel
    pass on the smallest power-of-two domain of at least 4 that covers
    ``domain``, walked up to ``WALK_STEPS`` more times while outside it,
    then reduced modulo ``domain``."""
    j = u32(j)
    d = torch.clamp(u32(domain), min=1)
    key = u32(key)
    bits = torch.clamp(ceil_log2(d), min=2)
    lo = (bits + 1) >> 1
    hi = bits - lo
    y = _feistel(j, lo, hi, key)
    for _ in range(WALK_STEPS):
        y = torch.where(y < d, y, _feistel(y, lo, hi, key))
    return torch.where(y < d, y, y % d)


def keep_mask(row_keys: torch.Tensor, width: int, keep_prob: float) -> torch.Tensor:
    """Dropout's keep mask [S, width]: ``mix32(row ^ col * GOLDEN)`` as a
    uniform in (0, 1), kept below ``keep_prob``."""
    col = torch.arange(width, dtype=torch.int64, device=row_keys.device)
    bits = mix32(u32(row_keys)[:, None] ^ ((col * GOLDEN) & M32))
    u = torch.clamp((bits >> 8).to(torch.float32) * (2.0**-24), min=2.0**-25)
    return u < keep_prob
