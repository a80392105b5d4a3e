// The neighbour samplers, one kernel per hop each, for Hopper, sm_90a:
// K6 (uniform), K7 (weighted: Gumbel top-k, or the inverse CDF with
// replacement) and K8 (weighted, from Walker alias tables).
//
// Plain C interface, loaded with ctypes by dist_gnn_tpu_torch/ops/sampling.py
// (built by dist_gnn_tpu_torch/kernels/build.py).  Each entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().  The float arithmetic of K7 and K8 is written with
// the round-to-nearest intrinsics (__fadd_rn, __fmul_rn, ...), which nvcc
// never contracts into a fused multiply-add, and the Gumbel key's log is
// taken in double and rounded once: the plain versions compute the same
// f32 operations in the same order (ops/sampling.py), so the keys, sums
// and picks equal theirs bit for bit.
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

#include <cmath>
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


// ---------------------------------------------------------------------------
// K7 and K8: weighted sampling.
//
// K7 dg_sample_biased computes dist_gnn_tpu/ops/sampling.py sample_biased
// (:671-761) and its plain version ops/sampling.py sample_biased_plain:
// * without replacement, the exact Gumbel-key (A-Res) top-k over the whole
//   row: edge offset off gets key log(u) / w with u =
//   bits_to_uniform(mix32(row_key ^ mix32(off))); zero-weight and
//   out-of-row edges are at -inf and never taken; the k largest keys are
//   taken in lax.top_k order (descending key, the lower offset first on a
//   tie), slot j valid while its key > -inf;
// * with replacement, the inverse CDF over 256-edge chunks: each chunk's
//   weights summed in row order from 0, the chunk sums added in order into
//   the row total; draw t targets bits_to_uniform(bits[b, t]) * total and
//   takes the first edge whose in-chunk running sum exceeds the target
//   less the chunks before; valid where the row's total is > 0 and the
//   target was found.
// The JAX package has no Pallas kernel here: XLA fuses its jnp sampler
// (a chunked fori_loop of top_k merges, or two chunked scans).  The plain
// version is tens of torch ops per 256-edge chunk of the longest row.
//
// Bound (without replacement, the main path's mode): bytes.  Every edge of
// every seed row is read once (its weight, 4 bytes; the k picks' indices
// after), with the seeds, keys and indptr pairs, and ids and mask written
// once: a hop reads the distinct 32-byte sectors of probs that its rows
// span, so its time grows with the frontier's degree, not with k.  The key
// (two hashes, a double log, a division) is ~100 operations an edge, far
// below the card's rate.  Design: one warp per seed row.  Lanes take 32
// consecutive edges at a time (coalesced weight loads) and compute their
// keys; a ballot finds the lanes whose key beats the current k-th, and
// those are inserted in lane (offset) order into a sorted list of k keys
// and offsets in shared memory (the warp counts the entries that beat the
// key and shifts the tail by one).  After the first k edges only a record
// key enters: ~k ln(deg / k) insertions a row, and past the first chunks
// most edges are ruled out by a fast float log (cannot_beat) before the
// exact key's double log is taken.  A warp's chunks are
// serial, so a row above kLongRow edges (a hub of the power-law graph has
// 226,746) is shared by the 16 warps of its block, each with its own list,
// and warp 0 merges the lists.  With replacement each lane owns draws
// t = lane, lane + 32, ...: it sums the row chunk by chunk in the plain
// version's order (the lanes read the same addresses, one broadcast) and
// walks it again to its target: O(deg) a draw, off the main path.
//
// K8 dg_sample_biased_alias computes ops/sampling.py sample_biased_alias
// (:764-895, window None) and sample_biased_alias_plain, from the Walker
// alias tables of utils/native.build_alias:
// * a draw from bits (b0, b1): j = b0 % max(deg, 1); the offset is j if
//   bits_to_uniform(b1) < alias_prob[start + j], else alias_idx[start + j];
// * with replacement, slot t takes draw t of bits[:, b, t]; every slot of
//   a valid row with deg > 0 is valid;
// * without replacement, a row of deg <= 2k takes the exact Gumbel top-k
//   (as K7's) over its <= 2k edges with the keys gkeys[b, off]; a longer
//   row makes T = 4k draws and takes the first k distinct, in draw order;
//   the slots it could not fill are masked and their number,
//   sum(max(k - distinct, 0)), is added to a device counter (overflow)
//   that nothing reads back inside the hop.
// Bound: bytes.  A long row's T draws each read one 8-byte (prob, alias)
// pair at a random offset (O(B * 4k) dependent reads), a short row its
// <= 2k weights once, the picks one index each.  Design: one warp per
// seed row; the T draws (or the <= 2k keys) go to shared memory, each
// lane tests its draws against the earlier ones (T^2 / 64 compares a lane)
// and a ballot ranks the first occurrences; a short row's keys are ranked
// by counting (4k^2 / 32 compares a lane).
//
// Both kernels take k <= kMaxK (the wrapper checks): a warp's list or
// draws live in at most 16 KB of shared memory.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;
constexpr int kChunk = 256;  // the CDF's chunk (sample_biased's chunk=256)
constexpr int kSmemBudget = 48 * 1024;
constexpr int kMaxWarps = 8;
constexpr int kTopkWarps = 16;    // K7's block: the warps that share a long row
constexpr int32_t kLongRow = 1024;  // longer rows are shared by a block
constexpr int kUnroll = 4;          // K7's chunks loaded and keyed together

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// prng.py bits_to_uniform: (bits >> 8) * 2^-24, nudged off 0 to 2^-25.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
  return fmaxf(u, 2.98023223876953125e-08f);
}

// The Gumbel key of an edge of weight w > 0: log(u) in double, rounded once
// to float, over w in f32.
__device__ __forceinline__ float gumbel_key(uint32_t bits, float w) {
  return __fdiv_rn((float)log((double)bits_to_uniform(bits)), w);
}

// Whether an edge's Gumbel key surely cannot exceed thr, from the fast
// __logf: its error is at most 2^-21.41 absolute on [0.5, 2] and 3 ulp
// elsewhere (CUDA's documented bounds), the key's log is rounded once to
// float and its division once, so the slack below (1e-6 absolute, 1e-6
// relative to the log and to thr * w) covers every difference.  It only
// skips the exact key of an edge that could not enter the list, so the
// picks are those of the exact keys.
__device__ __forceinline__ bool cannot_beat(uint32_t bits, float w, float thr) {
  const float lgf = __logf(bits_to_uniform(bits));
  const float bound = thr * w;  // -inf while the list is not full
  return lgf + 1e-6f + 1e-6f * fabsf(lgf) + 1e-6f * fabsf(bound) < bound;
}

template <typename IP>
__device__ __forceinline__ void row_extent(const IP* __restrict__ indptr, int32_t seed,
                                           int64_t n_nodes, int64_t& start, int32_t& deg,
                                           bool& valid) {
  valid = seed != kInvalid;
  int64_t node = valid ? seed : 0;
  node = node < 0 ? 0 : (node >= n_nodes ? n_nodes - 1 : node);
  start = (int64_t)indptr[node];
  deg = valid ? (int32_t)((int64_t)indptr[node + 1] - start) : 0;
}

__device__ __forceinline__ int64_t clamp_pos(int64_t pos, int64_t n_edges) {
  return pos < 0 ? 0 : (pos >= n_edges ? n_edges - 1 : pos);
}

// A candidate (key, offset) beats an entry when its key is larger, or equal
// with a lower offset: lax.top_k's order, a strict total order on a row.
__device__ __forceinline__ bool beats(float ka, int32_t oa, float kb, int32_t ob) {
  return ka > kb || (ka == kb && oa < ob);
}

// Insert (ck, co) into a warp's list of n <= k entries (descending, in
// shared memory) if it beats the k-th; every lane calls with the same
// arguments.  Returns the new n.
__device__ __forceinline__ int list_insert(float* lk, int32_t* lo, int n, int k, float ck, int32_t co,
                                           int lane) {
  if (n == k && !beats(ck, co, lk[k - 1], lo[k - 1])) return n;
  int cnt = 0;
  for (int i = lane; i < n; i += 32) cnt += beats(lk[i], lo[i], ck, co);
  const int p = (int)__reduce_add_sync(kFull, (unsigned)cnt);
  const int last = n < k ? n : k - 1;  // shift [p, last) to [p + 1, last]
  for (int top = last; top > p; top -= 32) {  // from the top block down
    const int i = top - lane;
    const bool act = i > p;
    float kv = 0.f;
    int32_t ov = 0;
    if (act) {
      kv = lk[i - 1];
      ov = lo[i - 1];
    }
    __syncwarp();
    if (act) {
      lk[i] = kv;
      lo[i] = ov;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lk[p] = ck;
    lo[p] = co;
  }
  __syncwarp();
  return n < k ? n + 1 : n;
}

// One warp's pass over the chunks c0, c0 + cstep, ... of a row (32 edges a
// chunk, a lane an edge), kUnroll chunks at a time: their weights are
// loaded and their keys computed together (independent loads and logs in
// flight; once the list is full, a key that cannot beat its k-th is not
// computed exactly, cannot_beat), then chunk by chunk, in offset order, a
// ballot finds the lanes
// whose key beats the list's k-th and those are inserted in lane order (the
// offsets of a pass increase, so a plain > suffices for the ballot).
// Returns the list's n.
__device__ __forceinline__ int topk_pass(const float* __restrict__ probs, int64_t start, int32_t deg,
                                         uint32_t rk, int64_t n_edges, float* lk, int32_t* lo, int k,
                                         int c0, int cstep, int lane) {
  int n = 0;
  for (int32_t first = c0 * 32; first < deg; first += kUnroll * cstep * 32) {
    const float thr = n == k ? lk[k - 1] : neg_inf();  // only rises within the chunks
    float key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t off = first + u * cstep * 32 + lane;
      const float w = off < deg ? probs[clamp_pos(start + off, n_edges)] : 0.f;
      const uint32_t bits = mix32(rk ^ mix32((uint32_t)off));
      key[u] = w > 0.f && !cannot_beat(bits, w, thr) ? gumbel_key(bits, w) : neg_inf();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t base = first + u * cstep * 32;
      unsigned cand = __ballot_sync(kFull, key[u] > (n == k ? lk[k - 1] : neg_inf()));
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        n = list_insert(lk, lo, n, k, __shfl_sync(kFull, key[u], src), base + src, lane);
      }
    }
  }
  return n;
}

__device__ __forceinline__ void topk_write(const int32_t* __restrict__ indices, int64_t start,
                                           int64_t n_edges, const int32_t* lo, int n, int k,
                                           int32_t* __restrict__ ids, uint8_t* __restrict__ mask,
                                           int64_t b, int lane) {
  for (int j = lane; j < k; j += 32) {
    const bool take = j < n;
    ids[b * k + j] = take ? indices[clamp_pos(start + lo[j], n_edges)] : kInvalid;
    mask[b * k + j] = take;
  }
}

// K7 without replacement: the Gumbel top-k of each row.  A block takes a
// group of as many rows as it has warps: each warp samples its own row if
// it has at most kLongRow edges; then the group's long rows, one after
// another, are shared by all the block's warps (warp w takes chunks w,
// w + warps, ...; each keeps its own list), and warp 0 merges the other
// warps' lists into its own.  The top-k under a strict total order is the
// top-k of the union of the parts' top-ks, so the result is the same.
template <typename IP>
__global__ void __launch_bounds__(kTopkWarps * 32)
sample_biased_topk_kernel(const IP* __restrict__ indptr, const int32_t* __restrict__ indices,
                          const float* __restrict__ probs, const int32_t* __restrict__ seeds,
                          const int64_t* __restrict__ keys, int32_t* __restrict__ ids,
                          uint8_t* __restrict__ mask, int64_t B, int k, int64_t n_nodes,
                          int64_t n_edges) {
  extern __shared__ float smem_f[];
  __shared__ int s_long[kTopkWarps];
  __shared__ int s_n[kTopkWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  float* lk = smem_f + (size_t)warp * 2 * k;       // keys, descending
  int32_t* lo = reinterpret_cast<int32_t*>(lk + k);  // their offsets
  for (int64_t g0 = (int64_t)blockIdx.x * wpb; g0 < B; g0 += (int64_t)gridDim.x * wpb) {
    const int64_t b = g0 + warp;
    bool is_long = false;
    if (b < B) {
      int64_t start;
      int32_t deg;
      bool valid;
      row_extent(indptr, seeds[b], n_nodes, start, deg, valid);
      is_long = deg > kLongRow;
      if (!is_long) {
        const int n = topk_pass(probs, start, deg, (uint32_t)keys[b], n_edges, lk, lo, k, 0, 1, lane);
        topk_write(indices, start, n_edges, lo, n, k, ids, mask, b, lane);
      }
    }
    if (lane == 0) s_long[warp] = is_long;
    __syncthreads();
    for (int r = 0; r < wpb; ++r) {
      if (!s_long[r]) continue;  // the same in every warp
      const int64_t br = g0 + r;
      int64_t start;
      int32_t deg;
      bool valid;
      row_extent(indptr, seeds[br], n_nodes, start, deg, valid);
      const int n = topk_pass(probs, start, deg, (uint32_t)keys[br], n_edges, lk, lo, k, warp, wpb, lane);
      if (lane == 0) s_n[warp] = n;
      __syncthreads();
      if (warp == 0) {
        int m = n;
        for (int w = 1; w < wpb; ++w) {
          const float* wk = smem_f + (size_t)w * 2 * k;
          const int32_t* wo = reinterpret_cast<const int32_t*>(wk + k);
          for (int i = 0; i < s_n[w]; ++i) {
            if (m == k && !beats(wk[i], wo[i], lk[k - 1], lo[k - 1])) break;  // the rest lose too
            m = list_insert(lk, lo, m, k, wk[i], wo[i], lane);
          }
        }
        topk_write(indices, start, n_edges, lo, m, k, ids, mask, br, lane);
      }
      __syncthreads();
    }
    __syncthreads();  // every list is the next group's
  }
}

// K7 with replacement: the chunked inverse CDF, one warp a row, a lane a
// draw (t = lane, lane + 32, ...).
template <typename IP>
__global__ void sample_biased_cdf_kernel(const IP* __restrict__ indptr,
                                         const int32_t* __restrict__ indices,
                                         const float* __restrict__ probs,
                                         const int32_t* __restrict__ seeds,
                                         const int64_t* __restrict__ keys, int32_t* __restrict__ ids,
                                         uint8_t* __restrict__ mask, int64_t B, int k,
                                         int64_t n_nodes, int64_t n_edges) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  for (int64_t b = (int64_t)blockIdx.x * wpb + warp; b < B; b += (int64_t)gridDim.x * wpb) {
    int64_t start;
    int32_t deg;
    bool valid;
    row_extent(indptr, seeds[b], n_nodes, start, deg, valid);
    const float* w = probs + start;
    float total = 0.f;
    for (int32_t c0 = 0; c0 < deg; c0 += kChunk) {
      const int32_t c1 = deg - c0 < kChunk ? deg : c0 + kChunk;
      float ct = 0.f;
      for (int32_t i = c0; i < c1; ++i) ct = __fadd_rn(ct, w[i]);
      total = __fadd_rn(total, ct);
    }
    for (int t = lane; t < k; t += 32) {
      const float target = __fmul_rn(bits_to_uniform((uint32_t)keys[b * k + t]), total);
      bool found = false;
      int32_t pick = 0;
      float before = 0.f;  // the chunks before this one
      for (int32_t c0 = 0; c0 < deg && !found; c0 += kChunk) {
        const int32_t c1 = deg - c0 < kChunk ? deg : c0 + kChunk;
        const float local = __fsub_rn(target, before);
        float cs = 0.f;
        for (int32_t i = c0; i < c1; ++i) {
          cs = __fadd_rn(cs, w[i]);
          if (local >= 0.f && cs > local) {
            found = true;
            pick = i;
            break;
          }
        }
        before = __fadd_rn(before, cs);
      }
      const bool take = valid && total > 0.f && found;
      ids[b * k + t] = take ? indices[clamp_pos(start + pick, n_edges)] : kInvalid;
      mask[b * k + t] = take;
    }
  }
}

// One alias draw: an offset within the row.
__device__ __forceinline__ int32_t alias_draw(uint32_t b0, uint32_t b1, int32_t deg, int64_t start,
                                              const float* __restrict__ alias_prob,
                                              const int32_t* __restrict__ alias_idx,
                                              int64_t n_edges) {
  const uint32_t j = b0 % (uint32_t)(deg > 1 ? deg : 1);
  const int64_t pos = clamp_pos(start + (int64_t)j, n_edges);
  return bits_to_uniform(b1) < alias_prob[pos] ? (int32_t)j : alias_idx[pos];
}

// K8: the alias sampler, one warp a row.
template <typename IP>
__global__ void sample_biased_alias_kernel(
    const IP* __restrict__ indptr, const int32_t* __restrict__ indices,
    const float* __restrict__ probs, const float* __restrict__ alias_prob,
    const int32_t* __restrict__ alias_idx, const int32_t* __restrict__ seeds,
    const int64_t* __restrict__ bits, const int64_t* __restrict__ gkeys,
    int32_t* __restrict__ ids, uint8_t* __restrict__ mask, int32_t* __restrict__ shortfall,
    int64_t B, int k, int64_t n_nodes, int64_t n_edges, int replace) {
  extern __shared__ float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int T = replace ? k : 4 * k, D = 2 * k;
  const int64_t plane = B * (int64_t)T;  // bits[1] follows bits[0]
  float* sk = smem_f + (size_t)warp * T;  // a short row's keys, or ...
  int32_t* sd = reinterpret_cast<int32_t*>(sk);  // ... a long row's draws
  for (int64_t b = (int64_t)blockIdx.x * wpb + warp; b < B; b += (int64_t)gridDim.x * wpb) {
    int64_t start;
    int32_t deg;
    bool valid;
    row_extent(indptr, seeds[b], n_nodes, start, deg, valid);
    const int64_t* b0 = bits + b * T;
    const int64_t* b1 = b0 + plane;
    if (replace) {
      const bool take = valid && deg > 0;
      for (int t = lane; t < k; t += 32) {
        int32_t id = kInvalid;
        if (take) {
          const int32_t sel = alias_draw((uint32_t)b0[t], (uint32_t)b1[t], deg, start, alias_prob,
                                         alias_idx, n_edges);
          id = indices[clamp_pos(start + sel, n_edges)];
        }
        ids[b * k + t] = id;
        mask[b * k + t] = take;
      }
      continue;
    }
    if (deg <= D) {  // the exact Gumbel top-k over the short row
      for (int o = lane; o < D; o += 32) {
        float key = neg_inf();
        if (o < deg) {
          const float w = probs[clamp_pos(start + o, n_edges)];
          if (w > 0.f) key = gumbel_key((uint32_t)gkeys[b * D + o], w);
        }
        sk[o] = key;
      }
      __syncwarp();
      for (int o = lane; o < D; o += 32) {
        const float ko = sk[o];
        int rank = 0;
        for (int j = 0; j < D; ++j) {
          const float kj = sk[j];
          rank += (kj > ko) || (kj == ko && j < o);
        }
        if (rank < k) {
          const bool take = valid && ko > neg_inf();
          ids[b * k + rank] = take ? indices[clamp_pos(start + o, n_edges)] : kInvalid;
          mask[b * k + rank] = take;
        }
      }
    } else {  // the first k distinct of T alias draws, in draw order
      for (int t = lane; t < T; t += 32)
        sd[t] = alias_draw((uint32_t)b0[t], (uint32_t)b1[t], deg, start, alias_prob, alias_idx,
                           n_edges);
      __syncwarp();
      int got = 0;  // first occurrences so far (the same in every lane)
      for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + lane;
        bool first = false;
        int32_t d = 0;
        if (t < T) {
          d = sd[t];
          first = true;
          for (int u = 0; u < t; ++u)
            if (sd[u] == d) {
              first = false;
              break;
            }
        }
        const unsigned bal = __ballot_sync(kFull, first);
        const int rank = got + __popc(bal & ((1u << lane) - 1u));
        if (first && rank < k) {
          ids[b * k + rank] = indices[clamp_pos(start + d, n_edges)];
          mask[b * k + rank] = 1;
        }
        got += __popc(bal);
      }
      for (int j = lane; j < k; j += 32)
        if (j >= got) {
          ids[b * k + j] = kInvalid;
          mask[b * k + j] = 0;
        }
      if (lane == 0 && got < k) atomicAdd(shortfall, k - got);
    }
    __syncwarp();  // shared memory is the next row's
  }
}

// Warps per block such that their shared memory fits the default 48 KB.
inline int warps_for(size_t smem_per_warp, int most = kMaxWarps) {
  if (smem_per_warp == 0) return most;
  const int w = (int)(kSmemBudget / smem_per_warp);
  return w < 1 ? 1 : (w > most ? most : w);
}

inline unsigned grid_for(int64_t rows, int wpb) {
  const int64_t blocks = (rows + wpb - 1) / wpb;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename IP>
int launch_sample_biased(const void* indptr, const int32_t* indices, const float* probs,
                         const int32_t* seeds, const int64_t* keys, int32_t* ids, uint8_t* mask,
                         int64_t B, int k, int64_t n_nodes, int64_t n_edges, int replace,
                         cudaStream_t stream) {
  const IP* ip = static_cast<const IP*>(indptr);
  if (replace) {
    sample_biased_cdf_kernel<IP><<<grid_for(B, kMaxWarps), kMaxWarps * 32, 0, stream>>>(
        ip, indices, probs, seeds, keys, ids, mask, B, k, n_nodes, n_edges);
  } else {
    const size_t per_warp = (size_t)2 * k * sizeof(float);
    const int wpb = warps_for(per_warp, kTopkWarps);
    sample_biased_topk_kernel<IP><<<grid_for(B, wpb), wpb * 32, wpb * per_warp, stream>>>(
        ip, indices, probs, seeds, keys, ids, mask, B, k, n_nodes, n_edges);
  }
  return (int)cudaGetLastError();
}

template <typename IP>
int launch_sample_biased_alias(const void* indptr, const int32_t* indices, const float* probs,
                               const float* alias_prob, const int32_t* alias_idx,
                               const int32_t* seeds, const int64_t* bits, const int64_t* gkeys,
                               int32_t* ids, uint8_t* mask, int32_t* shortfall, int64_t B, int k,
                               int64_t n_nodes, int64_t n_edges, int replace,
                               cudaStream_t stream) {
  const size_t per_warp = replace ? 0 : (size_t)4 * k * sizeof(float);
  const int wpb = warps_for(per_warp);
  sample_biased_alias_kernel<IP><<<grid_for(B, wpb), wpb * 32, wpb * per_warp, stream>>>(
      static_cast<const IP*>(indptr), indices, probs, alias_prob, alias_idx, seeds, bits, gkeys,
      ids, mask, shortfall, B, k, n_nodes, n_edges, replace);
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

// K7.  indptr, indices, seeds, ids and mask as for K6; probs [n_edges]
// f32 weights (>= 0); keys int64 holding uint32 values, [B] (replace = 0:
// the row keys) or [B, k] (replace = 1: one per draw).  Needs n_nodes >= 1,
// n_edges >= 1 and 1 <= k <= 1024 (B may be 0).
int dg_sample_biased(const void* indptr, int indptr_int64, const int32_t* indices,
                     const float* probs, const int32_t* seeds, const int64_t* keys, int32_t* ids,
                     uint8_t* mask, int64_t B, int k, int64_t n_nodes, int64_t n_edges,
                     int replace, void* stream) {
  if (B < 0 || k < 1 || k > kMaxK || n_nodes <= 0 || n_edges <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (indptr_int64)
    return launch_sample_biased<int64_t>(indptr, indices, probs, seeds, keys, ids, mask, B, k,
                                         n_nodes, n_edges, replace, st);
  return launch_sample_biased<int32_t>(indptr, indices, probs, seeds, keys, ids, mask, B, k,
                                       n_nodes, n_edges, replace, st);
}

// K8.  As K7, plus alias_prob [n_edges] f32 and alias_idx [n_edges] int32
// (utils/native.build_alias); bits int64 holding uint32 values, [2, B, T]
// with T = k (replace = 1) or 4k (replace = 0); gkeys [B, 2k] (replace = 0;
// unread otherwise); shortfall one int32 on the device, to which the
// masked slots of the long rows are added (replace = 0).
int dg_sample_biased_alias(const void* indptr, int indptr_int64, const int32_t* indices,
                           const float* probs, const float* alias_prob, const int32_t* alias_idx,
                           const int32_t* seeds, const int64_t* bits, const int64_t* gkeys,
                           int32_t* ids, uint8_t* mask, int32_t* shortfall, int64_t B, int k,
                           int64_t n_nodes, int64_t n_edges, int replace, void* stream) {
  if (B < 0 || k < 1 || k > kMaxK || n_nodes <= 0 || n_edges <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (indptr_int64)
    return launch_sample_biased_alias<int64_t>(indptr, indices, probs, alias_prob, alias_idx,
                                               seeds, bits, gkeys, ids, mask, shortfall, B, k,
                                               n_nodes, n_edges, replace, st);
  return launch_sample_biased_alias<int32_t>(indptr, indices, probs, alias_prob, alias_idx, seeds,
                                             bits, gkeys, ids, mask, shortfall, B, k, n_nodes,
                                             n_edges, replace, st);
}

}  // extern "C"
