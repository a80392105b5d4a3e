"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A run states the
card's own power limit beside every share of these."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
