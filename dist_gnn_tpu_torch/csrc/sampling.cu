// K6: uniform neighbour sampling, one kernel per hop, for Hopper, sm_90a.
//
// Plain C interface, loaded with ctypes by dist_gnn_tpu_torch/ops/sampling.py
// (built by dist_gnn_tpu_torch/kernels/build.py).  The entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// dg_sample_uniform: for seed row b and slot j of a CSC graph (indptr,
//   indices), ids[b, j] = indices[start_b + sel] where the slot is valid,
//   INVALID_ID where it is not, and mask[b, j] says which.  It computes
//   exactly the uniform path of dist_gnn_tpu/ops/sampling.py sample_uniform
//   (:305-350, the exact elementwise fetch) and its plain PyTorch version,
//   ops/sampling.py sample_uniform_plain.  The JAX package has no Pallas
//   kernel here: XLA fuses its jnp sampler.  The port's plain version runs
//   the keyed Feistel permutation op by op, 13 passes of 8 rounds of int64
//   elementwise ops per hop (thousands of launches a request); this kernel
//   is one launch per hop and writes nothing but its outputs.
//
//   Per (b, j):
//   * start = indptr[seed], deg = indptr[seed + 1] - start; an INVALID_ID
//     seed has deg 0 (_row_extents);
//   * without replacement: sel = j when deg <= k, else a keyed Feistel
//     permutation of [0, deg) at j (ops/prng.py feistel_permutation), and
//     the slot is valid while j < min(deg, k);
//   * with replacement: sel = bits[b, j] % max(deg, 1), and every slot of a
//     row with deg > 0 is valid;
//   * ids = indices[clamp(start + sel, 0, E - 1)] where valid.
//   The Feistel network runs in native uint32 arithmetic, where the plain
//   version emulates it in int64 masked to 32 bits: the same bits.  The
//   cycle walk stops as soon as y < deg; the plain version's
//   where(y < d, y, F(y)) never changes an in-range y, so stopping early
//   gives the same result in about 2 passes instead of 13.  After 12 walk
//   steps the fallback is y % deg, as there.
//
//   Bound by bytes: the valid slots read the distinct 32-byte sectors of
//   indices that their positions fall in (a row of degree <= k reads one
//   contiguous run; a longer row's picks may share sectors), the valid
//   seeds the sectors of their indptr pairs; each row reads its seed and
//   key; ids and mask are written once.  The Feistel arithmetic (~2 passes of 8 rounds of
//   ~12 integer operations per valid slot) is far below the card's integer
//   rate.  Design: one thread per (row, slot), so a warp covers a few
//   consecutive rows and their slots' outputs are stored coalesced; the
//   threads of a row read the same indptr pair, which the warp's load
//   broadcasts.  Seeds outside [0, N) are clamped into the graph and
//   positions into [0, E), so no read leaves an allocation.
//
// Keys arrive as int64 holding uint32 values (ops/prng.py random_keys): the
// kernel reads their low 32 bits.  indptr is int32 below 2^31 edges and
// int64 above (graph.py), so the kernel is templated on its type.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this
constexpr int32_t kInvalid = 0x7fffffff;  // INVALID_ID (graph.py)
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kRoundStep = 0x7F4A7C15u;
constexpr int kRounds = 8;     // prng.py _FEISTEL_ROUNDS
constexpr int kWalkSteps = 12;  // prng.py _WALK_STEPS

// murmur3 fmix32 (prng.py mix32)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// One pass of the unbalanced Feistel network on a 2^(lo + hi) domain
// (prng.py _feistel): each round maps (a, b) -> (b, a ^ (F(b) & mask_a)) and
// swaps the widths; the round count is even, so widths end where they began.
__device__ __forceinline__ uint32_t feistel(uint32_t x, int lo, int hi, uint32_t key) {
  int wb = lo, wa = hi;
  uint32_t b = x & ((1u << wb) - 1u);
  uint32_t a = (x >> wb) & ((1u << wa) - 1u);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t f = mix32((b * kGolden) ^ (key + (uint32_t)r * kRoundStep));
    const uint32_t na = b;
    b = a ^ (f & ((1u << wa) - 1u));
    a = na;
    const int w = wa;
    wa = wb;
    wb = w;
  }
  return (a << wb) | b;
}

// The keyed permutation of [0, d) at j, d >= 2 (prng.py feistel_permutation).
__device__ __forceinline__ uint32_t feistel_permutation(uint32_t j, uint32_t d, uint32_t key) {
  int bits = 32 - __clz((int)(d - 1u));  // ceil(log2 d) for d >= 2
  bits = bits > 2 ? bits : 2;
  const int lo = (bits + 1) >> 1, hi = bits - lo;
  uint32_t y = feistel(j, lo, hi, key);
  for (int s = 0; s < kWalkSteps && y >= d; ++s) y = feistel(y, lo, hi, key);
  return y < d ? y : y % d;
}

template <typename IP>
__global__ void __launch_bounds__(kThreads)
sample_uniform_kernel(const IP* __restrict__ indptr, const int32_t* __restrict__ indices,
                      const int32_t* __restrict__ seeds, const int64_t* __restrict__ keys,
                      int32_t* __restrict__ ids, uint8_t* __restrict__ mask, int64_t B, int k,
                      int64_t n_nodes, int64_t n_edges, int replace) {
  const int64_t total = B * k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int64_t b = e / k;
    const int j = (int)(e - b * k);
    const int32_t seed = seeds[b];
    const bool valid = seed != kInvalid;
    int64_t node = valid ? seed : 0;
    node = node < 0 ? 0 : (node >= n_nodes ? n_nodes - 1 : node);
    const int64_t start = (int64_t)indptr[node];
    const int32_t deg = valid ? (int32_t)((int64_t)indptr[node + 1] - start) : 0;
    bool take;
    uint32_t sel = 0;
    if (replace) {
      take = deg > 0;
      if (take) sel = (uint32_t)keys[e] % (uint32_t)deg;
    } else {
      take = j < (deg < k ? deg : k);
      if (take)
        sel = deg <= k ? (uint32_t)j
                       : feistel_permutation((uint32_t)j, (uint32_t)deg, (uint32_t)keys[b]);
    }
    int32_t id = kInvalid;
    if (take) {
      int64_t pos = start + (int64_t)sel;
      pos = pos < 0 ? 0 : (pos >= n_edges ? n_edges - 1 : pos);
      id = indices[pos];
    }
    ids[e] = id;
    mask[e] = take;
  }
}

template <typename IP>
int launch_sample_uniform(const void* indptr, const int32_t* indices, const int32_t* seeds,
                          const int64_t* keys, int32_t* ids, uint8_t* mask, int64_t B, int k,
                          int64_t n_nodes, int64_t n_edges, int replace, cudaStream_t stream) {
  const int64_t blocks = (B * k + kThreads - 1) / kThreads;
  sample_uniform_kernel<IP><<<(unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0,
                              stream>>>(static_cast<const IP*>(indptr), indices, seeds, keys, ids,
                                        mask, B, k, n_nodes, n_edges, replace);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6.  indptr [n_nodes + 1] of int32 (indptr_int64 = 0) or int64 (1);
// indices [n_edges] int32; seeds [B] int32, INVALID_ID padded; keys int64
// holding uint32 values, [B] (replace = 0) or [B, k] (replace = 1); ids
// [B, k] int32 and mask [B, k] (one byte per bool) are written whole.
// Needs n_nodes >= 1 and n_edges >= 1 (the wrapper answers an edgeless
// graph without a launch); B * k may be 0.
int dg_sample_uniform(const void* indptr, int indptr_int64, const int32_t* indices,
                      const int32_t* seeds, const int64_t* keys, int32_t* ids, uint8_t* mask,
                      int64_t B, int k, int64_t n_nodes, int64_t n_edges, int replace,
                      void* stream) {
  if (B < 0 || k < 0 || n_nodes <= 0 || n_edges <= 0) return (int)cudaErrorInvalidValue;
  if (B * k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (indptr_int64)
    return launch_sample_uniform<int64_t>(indptr, indices, seeds, keys, ids, mask, B, k, n_nodes,
                                          n_edges, replace, st);
  return launch_sample_uniform<int32_t>(indptr, indices, seeds, keys, ids, mask, B, k, n_nodes,
                                        n_edges, replace, st);
}

}  // extern "C"
