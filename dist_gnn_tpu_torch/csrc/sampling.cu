// The neighbour samplers, one kernel per hop each, for Hopper, sm_90a:
// K6 (uniform), K7 (weighted: Gumbel top-k, or the inverse CDF with
// replacement) and K8 (weighted, from Walker alias tables); and K10,
// dropout, whose keep mask is the same uint32 hash.
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
//   key; ids and mask are written once.  The Feistel walk is the larger
//   cost at the last hop all the same: ~110 integer operations a pass
//   (three multiplies a round), ~1.5 passes per slot of a row longer than
//   k, and a warp runs as many passes as its longest walk: with
//   replacement, which has no walk, the same hop takes a third of the time
//   (PERF.md).
//
//   Design: one thread per (row, slot), so a warp covers a few
//   consecutive rows, its slots' outputs are stored coalesced, and a hop
//   has as many loads in flight as it has slots; the threads of a row read
//   the same indptr pair, which the warp's load broadcasts.  A hop of
//   kQueueSlots (131,072) slots or more without replacement (the main
//   path's last) takes the packed kernel: a block takes kThreads
//   consecutive slots and finds its first row by one 64-bit division (each
//   thread its own by a 32-bit one); the first pass of the network runs in
//   every thread that needs it, and the slots still out of range after it
//   (fewer than half, for a domain just above a power of two) go into the
//   block's queue in shared memory and walk on packed into the block's
//   first warps, so a long
//   walk runs beside other walks, not beside lanes that are done.  Below
//   that size the queue's three barriers cost more than the walks they
//   pack, and the hop keeps the walk in place.  Also tried on the H100
//   and dropped, each slower at the last hop (PERF.md): a lane group per
//   row whose first lane reads the header, several rows a group and a
//   warp's walk queue; and four slots a thread with a block queue from
//   which each thread takes the next walk as its own ends.  Seeds outside
//   [0, N) are clamped into the graph and positions into [0, E), so no
//   read leaves an allocation.
//
// dg_dropout (K10): out[r, c] = in[r, c] * scale where the element is
//   kept, 0 where it is dropped, in the input's dtype (f32 or bf16), for
//   ops/dropout.py.  Kept means prng.py dropout_keep's test,
//   max((bits >> 8) * 2^-24, 2^-25) < (float)keep_prob with bits =
//   mix32(key_r ^ c * 0x9E3779B9), computed here in native uint32 where the
//   plain version emulates it in int64 (~23 elementwise passes of 8-byte
//   elements over [S, H], and a bool mask autograd keeps).  scale is the
//   f32 reciprocal of (float)(1 - rate): torch on the card divides by a
//   Python scalar by multiplying by that reciprocal, so the output equals
//   torch.where(keep, h / (1 - rate), 0) there bit for bit.  A dropout
//   with a fixed mask is linear and its own transpose, so the backward is
//   this kernel on the gradient with the same keys.  It replaces no TPU
//   kernel: the JAX package's dropout is jnp (dist_gnn_tpu/ops/prng.py:138
//   dropout_keep), which XLA fuses.
//
//   Bound by bytes: each element read once and written once (at the
//   training cells' shapes 247 MB a step in bf16, 988 MB in f32: 0.074 and
//   0.295 ms at 3.35 TB/s); the row keys are 8 bytes a row.  The hash is
//   ~10 integer operations an element, under the memory time.  Design: one
//   thread per 16-byte vector (8 bf16 or 4 f32), neighbouring threads on
//   neighbouring addresses, one key load a thread, a vector never across
//   two rows, as many blocks as vectors (grid-stride past 2^20 blocks); a
//   row width or pointer off 16 bytes takes a thread per element instead.
//   Indices are 32-bit: a call takes at most 2^31 elements (the training
//   cells' largest layer holds 111M).
//
// Keys arrive as int64 holding uint32 values (ops/prng.py random_keys): the
// kernel reads their low 32 bits.  indptr is int32 below 2^31 edges and
// int64 above (graph.py), so the kernel is templated on its type.

#include <cuda_bf16.h>
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
constexpr unsigned kFull = 0xffffffffu;

// A hop of this many slots or more, without replacement, takes the packed kernel.
constexpr int64_t kQueueSlots = 131072;

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

// One pass of the same network: feistel_permutation's step.
__device__ __forceinline__ uint32_t feistel_pass(uint32_t x, uint32_t d, uint32_t key) {
  int bits = 32 - __clz((int)(d - 1u));
  bits = bits > 2 ? bits : 2;
  const int lo = (bits + 1) >> 1;
  return feistel(x, lo, bits - lo, key);
}

// K6 for a hop of fewer than kQueueSlots slots: one thread per (row, slot),
// each walking its own slot (the parent design, kept as it was).
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

// K6 without replacement for a hop of kQueueSlots slots or more: as
// sample_uniform_kernel, a block taking kThreads consecutive slots (one
// 64-bit division a block, then a 32-bit one a thread), but the slots
// still out of range after the first pass go into the block's queue in
// shared memory and walk on packed into the block's first warps.
template <typename IP>
__global__ void __launch_bounds__(kThreads)
sample_uniform_packed_kernel(const IP* __restrict__ indptr, const int32_t* __restrict__ indices,
                             const int32_t* __restrict__ seeds, const int64_t* __restrict__ keys,
                             int32_t* __restrict__ ids, uint8_t* __restrict__ mask, int64_t B,
                             int k, int64_t n_nodes, int64_t n_edges) {
  __shared__ uint32_t q_y[kThreads], q_d[kThreads], q_k[kThreads];
  __shared__ int n_walk;
  const int lane = threadIdx.x & 31;
  const int64_t total = B * k;
  if (threadIdx.x == 0) n_walk = 0;
  for (int64_t e0 = (int64_t)blockIdx.x * kThreads; e0 < total; e0 += (int64_t)gridDim.x * kThreads) {
    const int64_t b0 = e0 / k;
    const int local = (int)(e0 - b0 * k) + (int)threadIdx.x;
    const int row = local / k;
    const int64_t b = b0 + row, e = e0 + threadIdx.x;
    const int j = local - row * k;
    const bool in = e < total;
    int64_t start = 0;
    int32_t deg = 0;
    uint32_t key = 0;
    if (in) {
      const int32_t seed = seeds[b];
      key = (uint32_t)keys[b];
      if (seed != kInvalid) {  // an INVALID_ID seed has degree 0 and reads nothing
        int64_t node = seed;
        node = node < 0 ? 0 : (node >= n_nodes ? n_nodes - 1 : node);
        start = (int64_t)indptr[node];
        deg = (int32_t)((int64_t)indptr[node + 1] - start);
      }
    }
    const bool take = j < (deg < k ? deg : k);
    const uint32_t d = (uint32_t)deg;
    uint32_t sel = (uint32_t)j;
    bool walk = false;
    if (take && deg > k) {
      sel = feistel_pass((uint32_t)j, d, key);
      walk = sel >= d;
    }
    __syncthreads();  // n_walk is 0, the queue free
    const unsigned all = __ballot_sync(kFull, walk);
    int base = 0;
    if (lane == 0 && all) base = atomicAdd(&n_walk, __popc(all));
    const int at = __shfl_sync(kFull, base, 0) + __popc(all & ((1u << lane) - 1u));
    if (walk) {
      q_y[at] = sel;
      q_d[at] = d;
      q_k[at] = key;
    }
    __syncthreads();
    if ((int)threadIdx.x < n_walk) {
      uint32_t y = q_y[threadIdx.x];
      const uint32_t qd = q_d[threadIdx.x], qk = q_k[threadIdx.x];
      for (int st = 0; st < kWalkSteps && y >= qd; ++st) y = feistel_pass(y, qd, qk);
      q_y[threadIdx.x] = y < qd ? y : y % qd;
    }
    __syncthreads();
    if (walk) sel = q_y[at];
    if (threadIdx.x == 0) n_walk = 0;
    if (in) {
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
}

template <typename IP>
int launch_sample_uniform(const void* indptr, const int32_t* indices, const int32_t* seeds,
                          const int64_t* keys, int32_t* ids, uint8_t* mask, int64_t B, int k,
                          int64_t n_nodes, int64_t n_edges, int replace, cudaStream_t stream) {
  const int64_t total = B * k;
  const int64_t blocks64 = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(blocks64 < kMaxBlocks ? blocks64 : kMaxBlocks);
  if (replace || total < kQueueSlots)
    sample_uniform_kernel<IP><<<blocks, kThreads, 0, stream>>>(
        static_cast<const IP*>(indptr), indices, seeds, keys, ids, mask, B, k, n_nodes, n_edges,
        replace);
  else
    sample_uniform_packed_kernel<IP><<<blocks, kThreads, 0, stream>>>(
        static_cast<const IP*>(indptr), indices, seeds, keys, ids, mask, B, k, n_nodes, n_edges);
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
// span, so its time grows with the frontier's edges (the sum of its rows'
// degrees), not with k and not with its longest row.  The key (two hashes,
// a double log, a division) is ~100 operations an edge, far below the
// card's rate.
//
// Design: the work is cut by the frontier's edges, not by its rows.  A
// call launches up to three kernels on the caller's stream and reads
// nothing back:
// 1. k7_rows_kernel: one warp per seed row of at most kShortRow edges.
//    Without replacement, lanes take 32 consecutive edges at a time
//    (coalesced weight loads) and compute their keys; a ballot finds the
//    lanes whose key beats the current k-th, and those are inserted in lane
//    (offset) order into a sorted list of k keys and offsets in shared
//    memory.  After the first k edges only a record key enters, and most
//    edges are ruled out by a fast float log (cannot_beat) before the exact
//    key's double log is taken.  When the graph's max_degree exceeds
//    kShortRow, block 0 meanwhile compacts the longer rows in row order and
//    scans their degrees: long row j owns the units [P_j, P_j + deg_j) of
//    one line of U = sum(deg_j) units, an edge a unit.
// 2. k7_slices_kernel (without replacement): W warps (kSliceWarpsPerSM an
//    SM) cut that line into ranges of Lu = max(kMinPiece, U / W,
//    maxdeg / (kMaxPieces - 1)) units, one a warp, regardless of row
//    boundaries, so every warp reads the same number of weights whatever
//    the rows' lengths.  A warp walks its range row by row as kernel 1
//    walks a row; a row wholly inside it is finished there, and the piece
//    of a row that crosses a range boundary (only its first and last row
//    can) leaves its list, packed, in one of the warp's two slots of the
//    workspace.  The pieces of one row share a lower bound of the row's
//    k-th key, an atomicMax on the key's order-preserving bits: the k-th
//    of a full list is the k-th of a subset of the row, so no edge whose
//    key is below it can be taken, and the fast-log filter and the ballot
//    skip such edges.  This is the threshold, not a radix select over the
//    key bits: it keeps the one pass over the weights that the bound
//    counts, where a select reads and keys every edge once more per pass.
// 3. k7_merge_kernel: one warp per split row (the warp whose range holds
//    the row's first edge) merges the lists of its at most kMaxPieces
//    pieces by k rounds of a warp-wide maximum over the lists' heads, key
//    bits and offset packed in 64 bits so that the maximum is lax.top_k's
//    order, and writes the picks in that order.
// Under a strict total order the top-k of a union is the top-k of the
// union of the parts' top-ks, and a part's list keeps every entry of the
// row's top-k that it holds (an entry leaves a list only for k entries
// that beat it, or is skipped only below the shared bound), so any split
// gives the whole row's picks.
// With replacement, kernel 1 takes its short rows one warp each (a lane
// sums a chunk; the warp folds the chunk sums in order into a table of
// before values), and 2'. k7_cdf_long_kernel takes the long rows, a block
// each from a device-side queue: its threads sum the row's chunks, one
// thread a chunk, through a shared tile that keeps the loads coalesced;
// one thread folds the chunk sums in order into the before values and the
// total; each draw then scans the chunk sums for its chunk (a warp ballot
// over 32 chunks a step: a binary search would assume that the float
// condition local >= 0 && sum > local changes once along the row, which
// rounding does not promise) and walks only that chunk: O(#chunks + 256)
// a draw, where the walk from the row's start was O(deg).  The with-
// replacement fold is sequential and not associative, so its chunk sums
// are held per block (in shared memory up to kCdfSmemChunks, else
// ceil(max_degree / 256) of them in the workspace), not per frontier.
// graph.max_degree sizes the workspace and picks the launch, but a row
// longer than it promised (the field understated) is still exact: without
// replacement the cut reads the rows' own degrees (or, below kShortRow,
// kernel 1 takes every row), and with replacement such a row's draws take
// its chunks with no table (draw_untabled), at O(deg) a draw.
// Workspace (from the caller, dg_sample_biased_workspace bytes; none when
// max_degree <= kShortRow): the compacted long rows (B entries of row,
// start and units); without replacement, per slice warp a shared bound on
// a 128-byte line (a split row's, at its first warp), a first row and two
// slots of k packed entries; with replacement, each block's chunk sums and
// before values.
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
// Bound: bytes, counted from what the function needs
// (scripts/bench_k8.py k8_bytes): a long row's bit pairs, alias_prob and,
// where a draw is rejected, alias_idx for its draws up to and including
// its k-th first occurrence (all T when it falls short: at degrees near
// 4k and k = 15 about 17 of the 60), a short row's weights and, at its
// positive weights, its keys, the picks' indices, the seeds and indptr
// pairs, and ids and mask written once.  Each needed draw is two
// dependent reads (its bits, then the table at a random position), so a
// row's time is a chain of DRAM latencies, and the design shortens it.
// Design: a group of G lanes a row: with replacement the least of 8, 16
// and 32 that holds k, so a warp takes 4 rows at k = 5 and 2 at k = 10 or
// 15; without, a warp, whose first round of 32 draws then holds the k-th
// first occurrence of nearly every row at k <= 15 (the sized groups there
// too, or rounds of 16 or 24 draws in a warp, took more rounds: up to
// 1.45x the device time on scripts/bench_k8.py's cases, PERF.md).  Blocks
// of 1 to 8 warps, as few as put a warp on every SM, so a hop of 512 rows
// reaches 128 SMs or more.  A valid row's first draws' bits load beside
// its indptr pair (DG_K8_PREFETCH), and a draw's alias_idx beside its
// alias_prob, as a short row's key beside its weight (DG_K8_PAIRED), so no
// load waits on another of the same draw.
// A long row (deg > 2k) reads its draws in draw order, in rounds: a round
// takes the next min(G, T - t) draws, one a lane, resolves them, takes the
// lowest lane of each value's match set (__match_any_sync) as the round's
// first, drops the values that an earlier round kept, ranks the rest by a
// ballot's popcount after the got kept so far, and keeps those of rank
// below k.  The loop ends after the round that holds the k-th first
// occurrence: no round starts after it, and that round's lanes past it
// (fewer than G) read their draws, which the bound does not charge.
// (Rounds of at most k - got draws would read none past it, but end a row
// in a chain of one-draw rounds, each two dependent reads: 1.08-2.26x the
// device time on scripts/bench_k8.py's cases, PERF.md.)  The kept offsets live, for
// k <= 32 (DG_K8_REG_MAX_K), in registers, lane i the i-th: a round
// compares its draws with them by got shuffles and appends its firsts by
// one shuffle from the lane of the q-th new first (nth_set); above, in an
// open-addressed set of 2^ceil(log2 2k) slots in shared memory (a lookup
// expects O(1) probes, an insert is an atomicCAS), the picks in order
// beside it.  No draw is compared with every earlier draw.
// Exactness: before the last round every first occurrence so far was kept
// (a round that finds k - got or more firsts is the last), so a draw is
// the first of its value in the row exactly when it is not among the kept
// offsets and is the first of its value within its round, and its rank
// is got plus the firsts of lower lanes: the order and ranks of the plain
// version's first occurrences.  The draws after the k-th first occurrence
// cannot change ids, mask or overflow, since the plain version takes only
// the first k first occurrences and counts a shortfall only when fewer
// than k exist; so ending there is exact.  A row that runs out of its T
// draws keeps what it has and adds k - got to overflow (summed over a
// warp's rows, one atomicAdd a warp).  The picks' indices are read once,
// at the row's end, and written with the mask.
// A short row (0 < deg <= 2k) writes its <= 2k Gumbel keys to shared
// memory and ranks them by counting (2k / G keys a lane, 2k compares a
// key); a row of degree 0 (or an INVALID_ID seed) writes its masked slots
// and nothing else.
//
// Both kernels take k <= kMaxK (the wrapper checks): K7's list lives in at
// most 16 KB of shared memory a warp, K8's set and picks in 20 KB.

constexpr int kMaxK = 1024;
constexpr int kChunk = 256;  // the CDF's chunk (sample_biased's chunk=256)
constexpr int kSmemBudget = 48 * 1024;
constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;               // K7's 32-edge steps whose weights load together (a group)
constexpr int32_t kShortRow = 1024;      // longer rows are cut across the grid
constexpr int kRowWarps = 16;            // k7_rows_kernel's block, at most
constexpr int kSliceWarps = 8;           // k7_slices_kernel's block, at most
constexpr int kSliceWarpsPerSM = 32;     // W = the SMs times this
constexpr int64_t kMinPiece = 1024;      // a slice warp's range, at least
constexpr int kPiecesPerLane = 8;        // a merge warp's lane holds this many lists
constexpr int kMaxPieces = 32 * kPiecesPerLane;  // a long row's pieces, at most
constexpr int kMergeWarps = 8;
constexpr int kWarpChunks = kShortRow / kChunk;  // a short row's chunks: the warp CDF's table
constexpr int kCdfWarps = 8;             // k7_cdf_long_kernel's block
constexpr int kCdfBlocksPerSM = 4;
constexpr int kCdfSmemChunks = 1536;     // a long row's chunk sums in shared memory, up to
constexpr unsigned kOrdNegInf = 0x007fffffu;  // ord(-inf)
constexpr int kBoundStride = 32;         // a shared bound a 128-byte line: its warps contend alone
// The register list's two choices, settable at build time (-D) so that
// scripts/bench_k7.py --variants can time them against the shared list
#ifndef DG_K7_REG_MAX_K
#define DG_K7_REG_MAX_K 32  // k up to this takes the register list (0: the shared list for every k)
#endif
#ifndef DG_K7_BATCH_INSERT
#define DG_K7_BATCH_INSERT 8  // 33: no batch insert
#endif
constexpr int kRegMaxK = DG_K7_REG_MAX_K;
static_assert(kRegMaxK >= 0 && kRegMaxK <= 32, "the register list holds at most a lane an entry");
constexpr int kBatchInsert = DG_K7_BATCH_INSERT;  // a step's candidates merged as one sorted batch, from
constexpr int kScanBatch = 8;            // rows whose loads the scan keeps in flight
constexpr size_t kScanSmem = 32 * (sizeof(int) + sizeof(long long) + sizeof(int));  // k7_scan_long's

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

// Whether an edge's Gumbel key is surely below thr, from the fast __logf:
// its error is at most 2^-21.41 absolute on [0.5, 2] and 3 ulp elsewhere
// (CUDA's documented bounds), the key's log is rounded once to float and
// its division once, so the slack below (1e-6 absolute, 1e-6 relative to
// the log and to thr * w) covers every difference.  It only skips the
// exact key of an edge whose key is below thr, strictly, so an edge that
// ties thr is still keyed and the picks are those of the exact keys.
__device__ __forceinline__ bool cannot_beat(uint32_t bits, float w, float thr) {
  const float lgf = __logf(bits_to_uniform(bits));
  const float bound = thr * w;  // -inf while there is no threshold
  return lgf + 1e-6f + 1e-6f * fabsf(lgf) + 1e-6f * fabsf(bound) < bound;
}

// Order-preserving unsigned bits of a float (no NaN here) and back.
__device__ __forceinline__ unsigned float_to_ord(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float ord_to_float(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// A list entry packed so that a larger value beats a smaller one: the key's
// order bits over the offset's complement (lax.top_k's order within a row);
// every entry is > 0, so 0 marks an empty head.
__device__ __forceinline__ unsigned long long pack_entry(float key, int32_t off) {
  return ((unsigned long long)float_to_ord(key) << 32) | (0xffffffffu - (uint32_t)off);
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

// The weights of kUnroll 32-edge steps from offset first (0 from o1 on).
__device__ __forceinline__ void step_weights(const float* __restrict__ probs, int64_t start, int32_t first,
                                             int32_t o1, int64_t n_edges, int lane, float (&w)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int32_t off = first + u * 32 + lane;
    w[u] = off < o1 ? probs[clamp_pos(start + off, n_edges)] : 0.f;
  }
}

// Whether an edge needs its exact key: a positive weight and a key not
// surely below thr (cannot_beat).
__device__ __forceinline__ bool needs_key(uint32_t bits, float w, float thr) {
  return w > 0.f && !cannot_beat(bits, w, thr);
}

// A relaxed load of a shared bound (other warps raise it with atomicMax).
__device__ __forceinline__ unsigned load_bound(const unsigned* bound) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bound));
  return v;
}

// A split row's shared lower bound of its k-th key: read it (lane 0, then
// broadcast) into seen, which only rises, and return it as a float; -inf
// for a row that is not shared (bound == nullptr).
__device__ __forceinline__ float read_bound(const unsigned* bound, unsigned& seen, int lane) {
  if (bound == nullptr) return neg_inf();
  unsigned b = 0;
  if (lane == 0) b = load_bound(bound);
  b = __shfl_sync(kFull, b, 0);
  seen = b > seen ? b : seen;
  return ord_to_float(seen);
}

// Raise the shared bound to a full list's k-th, if that is higher.
__device__ __forceinline__ void raise_bound(unsigned* bound, unsigned& seen, float kth, int lane) {
  const unsigned own = float_to_ord(kth);
  if (own > seen) {
    if (lane == 0) atomicMax(bound, own);
    seen = own;
  }
}

// One warp's pass over the edges [o0, o1) of a row, 32 edges a step (a
// lane an edge), the weights of kUnroll steps loaded together: step by
// step, in offset order, each lane keys its edge against the threshold
// (needs_key, then the exact key), a ballot finds the lanes whose key
// beats the list's k-th, and those are inserted in lane order (the
// offsets of a pass increase, so a plain > suffices).  The threshold is the list's k-th once it is full,
// raised to *bound when the row is shared with other warps (bound !=
// nullptr): the pass reads it each kUnroll steps, skips keys below it and
// raises it to its own k-th.  The list is sorted in shared memory (lk, lo:
// list_insert), for any k.  Returns the list's n.
__device__ __forceinline__ int topk_range(const float* __restrict__ probs, int64_t start, int32_t o0,
                                          int32_t o1, uint32_t rk, int64_t n_edges, float* lk,
                                          int32_t* lo, int k, int lane, unsigned* bound) {
  int n = 0;
  unsigned seen = kOrdNegInf;  // the shared bound as last read or raised
  for (int32_t first = o0; first < o1; first += kUnroll * 32) {
    const float shared_thr = read_bound(bound, seen, lane);
    float w[kUnroll];
    step_weights(probs, start, first, o1, n_edges, lane, w);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t base = first + u * 32;
      const float own = n == k ? lk[k - 1] : neg_inf();
      const uint32_t bits = mix32(rk ^ mix32((uint32_t)(base + lane)));
      const bool need = needs_key(bits, w[u], fmaxf(own, shared_thr));
      if (!__any_sync(kFull, need)) continue;  // most steps once the list is full
      const float key = need ? gumbel_key(bits, w[u]) : neg_inf();
      unsigned cand = __ballot_sync(kFull, key > own && key >= shared_thr);
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        n = list_insert(lk, lo, n, k, __shfl_sync(kFull, key, src), base + src, lane);
      }
    }
    if (bound != nullptr && n == k) raise_bound(bound, seen, lk[k - 1], lane);
  }
  return n;
}

// A warp's 32 packed entries (one a lane) sorted descending across the
// lanes: a bitonic network of 15 compare-exchange stages.
__device__ __forceinline__ unsigned long long sort_desc(unsigned long long v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
    }
  }
  return v;
}

// The 32 largest of two descending lane-sorted sequences, descending: the
// elementwise maximum of one and the other reversed is bitonic, and five
// half-cleaner stages sort it.
__device__ __forceinline__ unsigned long long merge_sorted(unsigned long long a, unsigned long long b, int lane) {
  const unsigned long long rb = __shfl_sync(kFull, b, 31 - lane);
  unsigned long long v = a > rb ? a : rb;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
    v = (lane & stride) == 0 ? (v > o ? v : o) : (v < o ? v : o);
  }
  return v;
}

// topk_range for k <= kRegMaxK, built for latency: the list lives in registers,
// lane j holding the j-th entry packed (pack_entry; 0 is empty) and all 32
// lanes kept sorted, so an insertion is one ballot for its position and one
// shuffle up, and a step with kBatchInsert candidates or more is sorted
// (sort_desc) and merged into the list (merge_sorted) in one go; a step
// whose lanes all fall below the threshold costs its hashes and fast logs
// alone; the next kUnroll steps' weights and the shared bound's next value
// are loaded while a group is ranked.  The same picks as topk_range.
// Returns n; lv is the lane's entry.
__device__ __forceinline__ int topk_range_reg(const float* __restrict__ probs, int64_t start, int32_t o0,
                                              int32_t o1, uint32_t rk, int64_t n_edges, int k, int lane,
                                              unsigned* bound, unsigned long long& lv) {
  lv = 0ull;
  unsigned long long kth = 0ull;  // lane k - 1's entry (the same in every lane), 0 until full
  float kth_key = neg_inf();      // its key
  unsigned seen = kOrdNegInf, next_bound = kOrdNegInf;
  if (bound != nullptr && lane == 0) next_bound = load_bound(bound);
  float w[kUnroll];
  step_weights(probs, start, o0, o1, n_edges, lane, w);
  for (int32_t first = o0; first < o1; first += kUnroll * 32) {
    float shared_thr = neg_inf();
    if (bound != nullptr) {  // read a group ago; the next read is in flight meanwhile
      const unsigned b = __shfl_sync(kFull, next_bound, 0);
      seen = b > seen ? b : seen;
      if (lane == 0 && first + kUnroll * 32 < o1) next_bound = load_bound(bound);
      shared_thr = ord_to_float(seen);
    }
    float wn[kUnroll];
    step_weights(probs, start, first + kUnroll * 32, o1, n_edges, lane, wn);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t off = first + u * 32 + lane;
      const uint32_t bits = mix32(rk ^ mix32((uint32_t)off));
      const bool need = needs_key(bits, w[u], fmaxf(kth_key, shared_thr));
      if (!__any_sync(kFull, need)) continue;  // most steps once the list is full
      const float key = need ? gumbel_key(bits, w[u]) : neg_inf();
      const unsigned long long cv = key > neg_inf() && key >= shared_thr ? pack_entry(key, off) : 0ull;
      unsigned cand = __ballot_sync(kFull, cv > kth);
      if (__popc(cand) >= kBatchInsert) {
        lv = merge_sorted(lv, sort_desc(cv > kth ? cv : 0ull, lane), lane);
        cand = 0;
      }
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const unsigned long long c = __shfl_sync(kFull, cv, src);
        const unsigned long long up = __shfl_up_sync(kFull, lv, 1);
        const int p = __popc(__ballot_sync(kFull, lv > c));
        if (p < k) lv = lane == p ? c : (lane > p ? up : lv);
      }
      kth = __shfl_sync(kFull, lv, k - 1);
      kth_key = kth ? ord_to_float((unsigned)(kth >> 32)) : neg_inf();
    }
    if (bound != nullptr && kth != 0ull) raise_bound(bound, seen, kth_key, lane);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = wn[u];
  }
  const int n = __popc(__ballot_sync(kFull, lv != 0ull));
  return n < k ? n : k;
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

// topk_write for a register list: lane j writes slot j.
__device__ __forceinline__ void topk_write_reg(const int32_t* __restrict__ indices, int64_t start,
                                               int64_t n_edges, unsigned long long lv, int n, int k,
                                               int32_t* __restrict__ ids, uint8_t* __restrict__ mask,
                                               int64_t b, int lane) {
  if (lane < k) {
    const bool take = lane < n;
    const int32_t off = (int32_t)(0xffffffffu - (uint32_t)lv);
    ids[b * k + lane] = take ? indices[clamp_pos(start + off, n_edges)] : kInvalid;
    mask[b * k + lane] = take;
  }
}

// The walk of draw t's chunk: the first edge of [i0, i1) whose running sum
// from 0 exceeds local (weights loaded 8 ahead of the dependent adds).
__device__ __forceinline__ bool walk_chunk(const float* __restrict__ w, int32_t i0, int32_t i1,
                                           float local, int32_t& pick) {
  float cs = 0.f;
  for (int32_t i = i0; i < i1; i += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = i + q < i1 ? w[i + q] : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      cs = __fadd_rn(cs, v[q]);
      if (i + q < i1 && cs > local) {
        pick = i + q;
        return true;
      }
    }
  }
  return false;
}

// The sum of chunk c of a row of deg edges, added from its first edge.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ w, int32_t deg, int32_t c) {
  const int32_t i1 = deg - c * kChunk < kChunk ? deg : c * kChunk + kChunk;
  float s = 0.f;
  for (int32_t i = c * kChunk; i < i1; ++i) s = __fadd_rn(s, w[i]);
  return s;
}

// A row longer than graph.max_degree promised has no table: its draws are
// taken with no table at the parent design's cost, O(deg) a draw, and the
// same arithmetic.  row_total_warp: the row's total by one warp (lane l
// sums chunks l, l + 32, ..., folded in order); draw_untabled: the first
// chunk whose local target is >= 0 and below its sum, each summed anew,
// and the walk of that chunk.
__device__ float row_total_warp(const float* __restrict__ w, int32_t deg, int32_t nch, int lane) {
  float total = 0.f;
  for (int32_t c0 = 0; c0 < nch; c0 += 32) {
    const float cs = c0 + lane < nch ? chunk_sum(w, deg, c0 + lane) : 0.f;
    const int32_t m = nch - c0 < 32 ? nch - c0 : 32;
    for (int32_t i = 0; i < m; ++i) total = __fadd_rn(total, __shfl_sync(kFull, cs, i));
  }
  return total;
}

__device__ bool draw_untabled(const float* __restrict__ w, int32_t deg, int32_t nch, float target,
                              int32_t& pick) {
  float before = 0.f;
  for (int32_t c = 0; c < nch; ++c) {
    const float cs = chunk_sum(w, deg, c);
    const float local = __fsub_rn(target, before);
    if (local >= 0.f && cs > local) {
      const int32_t i1 = deg - c * kChunk < kChunk ? deg : c * kChunk + kChunk;
      return walk_chunk(w, c * kChunk, i1, local, pick);
    }
    before = __fadd_rn(before, cs);
  }
  return false;
}

// K7 with replacement on one short row (at most kWarpChunks chunks, as the
// graph's max_degree promises), by one warp: lane c sums chunk c, the warp
// folds the sums in order into the total and a table of (sum, before) in
// shared memory; each lane then takes draws t = lane, lane + 32, ...: the
// first chunk of the table whose local target is >= 0 and below its sum,
// and the walk of that chunk alone.  A longer row takes draw_untabled.
__device__ __forceinline__ void cdf_row_warp(const float* __restrict__ probs,
                                             const int32_t* __restrict__ indices,
                                             const int64_t* __restrict__ keys, int32_t* __restrict__ ids,
                                             uint8_t* __restrict__ mask, int64_t b, int64_t start,
                                             int32_t deg, bool valid, int k, int64_t n_edges,
                                             float* tab, int lane) {
  const float* w = probs + start;
  const int32_t nch = (deg + kChunk - 1) / kChunk;
  const bool tabled = nch <= kWarpChunks;
  float total = 0.f;
  if (tabled) {
    const float ct = lane < nch ? chunk_sum(w, deg, lane) : 0.f;
    for (int c = 0; c < nch; ++c) {
      const float cc = __shfl_sync(kFull, ct, c);
      if (lane == 0) {
        tab[c] = cc;
        tab[kWarpChunks + c] = total;
      }
      total = __fadd_rn(total, cc);
    }
    __syncwarp();
  } else {
    total = row_total_warp(w, deg, nch, lane);
  }
  for (int t = lane; t < k; t += 32) {
    const float target = __fmul_rn(bits_to_uniform((uint32_t)keys[b * k + t]), total);
    bool found = false;
    int32_t pick = 0;
    for (int32_t c = 0; tabled && c < nch; ++c) {
      const float local = __fsub_rn(target, tab[kWarpChunks + c]);
      if (local >= 0.f && tab[c] > local) {
        const int32_t i1 = deg - c * kChunk < kChunk ? deg : c * kChunk + kChunk;
        found = walk_chunk(w, c * kChunk, i1, local, pick);
        break;
      }
    }
    if (!tabled) found = draw_untabled(w, deg, nch, target, pick);
    const bool take = valid && total > 0.f && found;
    ids[b * k + t] = take ? indices[clamp_pos(start + pick, n_edges)] : kInvalid;
    mask[b * k + t] = take;
  }
  __syncwarp();  // the table is the next row's
}

// The long rows' line, shared by K7's kernels through the workspace.
struct K7Header {
  int64_t n_long;   // long rows (deg > kShortRow), compacted in row order
  int64_t units;    // U: their edges
  int64_t piece;    // Lu: a slice warp's range of units
  int64_t workers;  // slice warps with a range: ceil(U / Lu) <= W
  unsigned queue;   // the next long row of k7_cdf_long_kernel
};

struct K7Work {
  K7Header* hdr;
  int32_t* lrow;                  // [B] the long rows' row index b
  int64_t* lstart;                // [B] their start in the edge list
  int64_t* lunits;                // [B + 1] their first unit P_j; lunits[n_long] = U
  unsigned* bound;                // [W, kBoundStride] each split row's k-th-key bound, at its first warp
  int32_t* first;                 // [W] each slice warp's first long row
  int2* slot_hdr;                 // [2W] (long row, entries) of each warp's two slots
  unsigned long long* slot_ent;   // [2W, k] their packed lists, descending
  float* cdf;                     // [Gb, 2, nchmax] each block's chunk sums and befores (with replacement)
  int64_t workers_max;            // W
  int64_t nchmax;                 // ceil(max_degree / kChunk)
};

struct K7Layout {
  size_t hdr = 0, lrow = 0, lstart = 0, lunits = 0, bound = 0, first = 0, slot_hdr = 0,
         slot_ent = 0, cdf = 0, total = 0;
  int64_t W = 0, Gb = 0, nchmax = 0, sms = 0;
};

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return 0;
  return sms;
}

// The workspace's regions (256-byte aligned) for B rows, k, a graph whose
// longest row has max_degree edges, and sms multiprocessors; none when no
// row can be long.
inline K7Layout k7_layout(int64_t B, int k, int64_t max_degree, int replace, int sms) {
  K7Layout L;
  L.sms = sms;
  if (max_degree <= kShortRow) return L;
  L.W = (int64_t)sms * kSliceWarpsPerSM;
  L.Gb = (int64_t)sms * kCdfBlocksPerSM;
  L.nchmax = (max_degree + kChunk - 1) / kChunk;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off = (off + bytes + 255) / 256 * 256;
    return at;
  };
  L.hdr = take(sizeof(K7Header));
  L.lrow = take((size_t)B * sizeof(int32_t));
  L.lstart = take((size_t)B * sizeof(int64_t));
  L.lunits = take((size_t)(B + 1) * sizeof(int64_t));
  if (replace) {
    L.cdf = take((size_t)L.Gb * 2 * L.nchmax * sizeof(float));
  } else {
    L.bound = take((size_t)L.W * kBoundStride * sizeof(unsigned));
    L.first = take((size_t)L.W * sizeof(int32_t));
    L.slot_hdr = take((size_t)2 * L.W * sizeof(int2));
    L.slot_ent = take((size_t)2 * L.W * k * sizeof(unsigned long long));
  }
  L.total = off;
  return L;
}

inline K7Work k7_bind(const K7Layout& L, void* ws) {
  char* p = static_cast<char*>(ws);
  K7Work w;
  w.hdr = reinterpret_cast<K7Header*>(p + L.hdr);
  w.lrow = reinterpret_cast<int32_t*>(p + L.lrow);
  w.lstart = reinterpret_cast<int64_t*>(p + L.lstart);
  w.lunits = reinterpret_cast<int64_t*>(p + L.lunits);
  w.bound = reinterpret_cast<unsigned*>(p + L.bound);
  w.first = reinterpret_cast<int32_t*>(p + L.first);
  w.slot_hdr = reinterpret_cast<int2*>(p + L.slot_hdr);
  w.slot_ent = reinterpret_cast<unsigned long long*>(p + L.slot_ent);
  w.cdf = reinterpret_cast<float*>(p + L.cdf);
  w.workers_max = L.W;
  w.nchmax = L.nchmax;
  return w;
}

// The extents of rows [b, b + kScanBatch) below b1 (deg 0 past b1).
template <typename IP>
__device__ __forceinline__ void scan_batch(const IP* __restrict__ indptr, const int32_t* __restrict__ seeds,
                                           int64_t b, int64_t b1, int64_t n_nodes, int64_t (&start)[kScanBatch],
                                           int32_t (&deg)[kScanBatch]) {
  int32_t sd[kScanBatch];
#pragma unroll
  for (int q = 0; q < kScanBatch; ++q) sd[q] = b + q < b1 ? seeds[b + q] : kInvalid;
#pragma unroll
  for (int q = 0; q < kScanBatch; ++q) {
    bool valid;
    row_extent(indptr, sd[q], n_nodes, start[q], deg[q], valid);
  }
}

// Block 0 of k7_rows_kernel when rows can be long: the long rows in row
// order (thread t takes the rows [t R, t R + R)), their units by an
// exclusive block scan, the slice warps' ranges and first rows, the shared
// bounds at -inf and the queue at 0.
template <typename IP>
__device__ void k7_scan_long(const IP* __restrict__ indptr, const int32_t* __restrict__ seeds,
                             int64_t B, int64_t n_nodes, int replace, K7Work w) {
  __shared__ int s_cnt[32];
  __shared__ long long s_sum[32];
  __shared__ int s_max[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
  const int64_t R = (B + blockDim.x - 1) / blockDim.x;
  const int64_t b0 = (int64_t)t * R < B ? (int64_t)t * R : B;
  const int64_t b1 = b0 + R < B ? b0 + R : B;
  int cnt = 0, mx = 0;
  long long sum = 0;
  for (int64_t b = b0; b < b1; b += kScanBatch) {  // a batch's loads in flight together
    int32_t deg[kScanBatch];
    int64_t start[kScanBatch];
    scan_batch(indptr, seeds, b, b1, n_nodes, start, deg);
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      if (deg[q] > kShortRow) {
        ++cnt;
        sum += deg[q];
        mx = deg[q] > mx ? deg[q] : mx;
      }
    }
  }
  // inclusive warp scans, then the warps' totals
  int ci = cnt;
  long long si = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int cy = __shfl_up_sync(kFull, ci, d);
    const long long sy = __shfl_up_sync(kFull, si, d);
    if (lane >= d) {
      ci += cy;
      si += sy;
    }
  }
  const int wmax = (int)__reduce_max_sync(kFull, (unsigned)mx);
  if (lane == 31) {
    s_cnt[warp] = ci;
    s_sum[warp] = si;
    s_max[warp] = wmax;
  }
  __syncthreads();
  if (warp == 0) {
    int c = lane < nw ? s_cnt[lane] : 0;
    long long s = lane < nw ? s_sum[lane] : 0;
    const int m = (int)__reduce_max_sync(kFull, (unsigned)(lane < nw ? s_max[lane] : 0));
    for (int d = 1; d < 32; d <<= 1) {
      const int cy = __shfl_up_sync(kFull, c, d);
      const long long sy = __shfl_up_sync(kFull, s, d);
      if (lane >= d) {
        c += cy;
        s += sy;
      }
    }
    if (lane < nw) {  // inclusive over the warps
      s_cnt[lane] = c;
      s_sum[lane] = s;
    }
    if (lane == 0) s_max[0] = m;
  }
  __syncthreads();
  const int64_t n_long = s_cnt[nw - 1];
  const int64_t U = s_sum[nw - 1];
  const int64_t maxdeg = s_max[0];
  int64_t Lu = (U + w.workers_max - 1) / w.workers_max;
  const int64_t by_row = (maxdeg + kMaxPieces - 2) / (kMaxPieces - 1);
  Lu = Lu > kMinPiece ? Lu : kMinPiece;
  Lu = Lu > by_row ? Lu : by_row;
  const int64_t workers = (U + Lu - 1) / Lu;
  if (t == 0) {
    w.hdr->n_long = n_long;
    w.hdr->units = U;
    w.hdr->piece = Lu;
    w.hdr->workers = workers;
    w.hdr->queue = 0;
    w.lunits[n_long] = U;
  }
  int64_t j = (warp ? s_cnt[warp - 1] : 0) + ci - cnt;  // exclusive prefixes
  int64_t P = (warp ? s_sum[warp - 1] : 0) + si - sum;
  for (int64_t b = b0; b < b1; b += kScanBatch) {
    int32_t deg[kScanBatch];
    int64_t start[kScanBatch];
    scan_batch(indptr, seeds, b, b1, n_nodes, start, deg);
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      if (deg[q] <= kShortRow) continue;
      w.lrow[j] = (int32_t)(b + q);
      w.lstart[j] = start[q];
      w.lunits[j] = P;
      if (!replace) {
        w.bound[P / Lu * kBoundStride] = kOrdNegInf;  // its first warp's: one split row a warp
        for (int64_t g = (P + Lu - 1) / Lu; g * Lu < P + deg[q]; ++g) w.first[g] = (int32_t)j;  // ranges starting here
      }
      ++j;
      P += deg[q];
    }
  }
}

// K7, kernel 1: one warp per seed row of at most kShortRow edges (every
// row when none is longer), and, when scan, block 0 compacts the long rows.
template <typename IP>
__global__ void __launch_bounds__(kRowWarps * 32, 2)
k7_rows_kernel(const IP* __restrict__ indptr, const int32_t* __restrict__ indices,
               const float* __restrict__ probs, const int32_t* __restrict__ seeds,
               const int64_t* __restrict__ keys, int32_t* __restrict__ ids,
               uint8_t* __restrict__ mask, int64_t B, int k, int64_t n_nodes, int64_t n_edges,
               int replace, int scan, K7Work work) {
  extern __shared__ float smem_f[];
  if (scan && blockIdx.x == 0) {
    k7_scan_long(indptr, seeds, B, n_nodes, replace, work);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int64_t blk = blockIdx.x - (scan ? 1 : 0), nblk = gridDim.x - (scan ? 1 : 0);
  float* lk = smem_f + (size_t)warp * (replace ? 2 * kWarpChunks : 2 * k);  // keys, descending
  int32_t* lo = reinterpret_cast<int32_t*>(lk + k);                          // their offsets
  for (int64_t b = blk * wpb + warp; b < B; b += nblk * wpb) {
    int64_t start;
    int32_t deg;
    bool valid;
    row_extent(indptr, seeds[b], n_nodes, start, deg, valid);
    if (scan && deg > kShortRow) continue;  // a long row: kernels 2-3 (or 2')
    if (replace) {
      cdf_row_warp(probs, indices, keys, ids, mask, b, start, deg, valid, k, n_edges, lk, lane);
    } else if (k <= kRegMaxK) {
      unsigned long long lv;
      const int n = topk_range_reg(probs, start, 0, deg, (uint32_t)keys[b], n_edges, k, lane, nullptr, lv);
      topk_write_reg(indices, start, n_edges, lv, n, k, ids, mask, b, lane);
    } else {
      const int n = topk_range(probs, start, 0, deg, (uint32_t)keys[b], n_edges, lk, lo, k, lane, nullptr);
      topk_write(indices, start, n_edges, lo, n, k, ids, mask, b, lane);
    }
  }
}

// K7 without replacement, kernel 2: warp g takes the units [g Lu, g Lu +
// Lu) of the long rows' line; rows wholly inside are written, the pieces
// of split rows go to the warp's slots (0: its first row, 1: its last).
__global__ void __launch_bounds__(kSliceWarps * 32, kSliceWarpsPerSM / kSliceWarps)
k7_slices_kernel(const int32_t* __restrict__ indices, const float* __restrict__ probs,
                 const int64_t* __restrict__ keys, int32_t* __restrict__ ids,
                 uint8_t* __restrict__ mask, int k, int64_t n_edges, K7Work work) {
  extern __shared__ float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int64_t g = (int64_t)blockIdx.x * wpb + warp;
  const K7Header h = *work.hdr;
  if (g >= h.workers) return;
  float* lk = smem_f + (size_t)warp * 2 * k;
  int32_t* lo = reinterpret_cast<int32_t*>(lk + k);
  const int64_t s = g * h.piece;
  const int64_t e = s + h.piece < h.units ? s + h.piece : h.units;
  if (lane == 0) {
    work.slot_hdr[2 * g] = make_int2(-1, 0);
    work.slot_hdr[2 * g + 1] = make_int2(-1, 0);
  }
  const int64_t j0 = work.first[g];
  for (int64_t j = j0; j < h.n_long; ++j) {
    const int64_t P0 = work.lunits[j];
    if (P0 >= e) break;
    const int64_t P1 = work.lunits[j + 1];
    const int64_t b = work.lrow[j], start = work.lstart[j];
    const int32_t o0 = (int32_t)(s > P0 ? s - P0 : 0);
    const int32_t o1 = (int32_t)((e < P1 ? e : P1) - P0);
    const bool whole = P0 >= s && P1 <= e;
    unsigned* bound = whole ? nullptr : work.bound + P0 / h.piece * kBoundStride;
    const int64_t slot = 2 * g + (j == j0 ? 0 : 1);
    if (k <= kRegMaxK) {
      unsigned long long lv;
      const int n = topk_range_reg(probs, start, o0, o1, (uint32_t)keys[b], n_edges, k, lane, bound, lv);
      if (whole) {
        topk_write_reg(indices, start, n_edges, lv, n, k, ids, mask, b, lane);
      } else {
        if (lane < n) work.slot_ent[slot * k + lane] = lv;
        if (lane == 0) work.slot_hdr[slot] = make_int2((int32_t)j, n);
      }
    } else {
      const int n = topk_range(probs, start, o0, o1, (uint32_t)keys[b], n_edges, lk, lo, k, lane, bound);
      if (whole) {
        topk_write(indices, start, n_edges, lo, n, k, ids, mask, b, lane);
      } else {
        for (int i = lane; i < n; i += 32) work.slot_ent[slot * k + i] = pack_entry(lk[i], lo[i]);
        if (lane == 0) work.slot_hdr[slot] = make_int2((int32_t)j, n);
      }
    }
    __syncwarp();  // the list is the next row's
  }
}

// K7 without replacement, kernel 3: warp g merges the split row whose first
// unit lies in its range (if any): the lists of the warps g .. z it spans
// (g's slot 0 or 1, then slot 0 of each), lane l holding lists l, l + 32,
// ...; each round the warp's largest head (packed: lax.top_k's order) is
// the next pick, and its list advances.
__global__ void __launch_bounds__(kMergeWarps * 32)
k7_merge_kernel(const int32_t* __restrict__ indices, int32_t* __restrict__ ids,
                uint8_t* __restrict__ mask, int k, int64_t n_edges, K7Work work) {
  extern __shared__ int32_t smem_i[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int64_t g = (int64_t)blockIdx.x * wpb + warp;
  const K7Header h = *work.hdr;
  if (g >= h.workers) return;
  int32_t* picks = smem_i + (size_t)warp * k;  // the picks' offsets, in order
  const int64_t s = g * h.piece;
  const int2 h0 = work.slot_hdr[2 * g], h1 = work.slot_hdr[2 * g + 1];
  int64_t j = -1, first_slot = 0;
  if (h0.x >= 0 && work.lunits[h0.x] == s) {
    j = h0.x;
    first_slot = 2 * g;
  } else if (h1.x >= 0) {
    j = h1.x;
    first_slot = 2 * g + 1;
  }
  if (j < 0) return;
  const int64_t z = (work.lunits[j + 1] - 1) / h.piece;  // the last warp it spans
  const int64_t L = z - g + 1;
  if (L > kMaxPieces) __trap();  // piece >= maxdeg / (kMaxPieces - 1) rules this out
  unsigned long long head[kPiecesPerLane], next[kPiecesPerLane];
  int cur[kPiecesPerLane], cnt[kPiecesPerLane];
#pragma unroll
  for (int q = 0; q < kPiecesPerLane; ++q) {
    const int64_t i = lane + 32 * q;
    const int64_t slot = i == 0 ? first_slot : 2 * (g + i);
    cnt[q] = i < L ? work.slot_hdr[slot].y : 0;
    head[q] = cnt[q] > 0 ? work.slot_ent[slot * k] : 0ull;
    next[q] = cnt[q] > 1 ? work.slot_ent[slot * k + 1] : 0ull;
    cur[q] = 2;
  }
  int got = 0;
  for (; got < k; ++got) {
    unsigned long long best = 0ull;
#pragma unroll
    for (int q = 0; q < kPiecesPerLane; ++q) best = head[q] > best ? head[q] : best;
    const unsigned hi = __reduce_max_sync(kFull, (unsigned)(best >> 32));
    const unsigned lo = __reduce_max_sync(kFull, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
    if (hi == 0u) break;  // every list is spent
    const unsigned long long win = ((unsigned long long)hi << 32) | lo;
#pragma unroll
    for (int q = 0; q < kPiecesPerLane; ++q) {
      if (head[q] == win) {  // one (lane, list) holds it: offsets differ
        const int64_t i = lane + 32 * q;
        const int64_t slot = i == 0 ? first_slot : 2 * (g + i);
        head[q] = next[q];
        next[q] = cur[q] < cnt[q] ? work.slot_ent[slot * k + cur[q]] : 0ull;
        ++cur[q];
      }
    }
    if (lane == 0) picks[got] = (int32_t)(0xffffffffu - lo);
  }
  __syncwarp();
  const int64_t b = work.lrow[j], start = work.lstart[j];
  for (int jj = lane; jj < k; jj += 32) {
    const bool take = jj < got;
    ids[b * k + jj] = take ? indices[clamp_pos(start + picks[jj], n_edges)] : kInvalid;
    mask[b * k + jj] = take;
  }
}

// K7 with replacement, kernel 2': a block per long row from the queue.  Warp
// v sums the chunk groups v, v + kCdfWarps, ... (32 chunks, a lane a chunk):
// per 32-edge step the warp loads the 32 chunks' edges coalesced (the next
// step's loads in flight meanwhile) into a shared tile and each lane adds
// its chunk's row of the tile in order; one thread folds the sums into the
// befores and the total (in shared memory when the row has at most
// kCdfSmemChunks chunks, else in the block's workspace); warp v takes the
// draws v, v + kCdfWarps, ...: a ballot over 32 chunks a step finds the
// first chunk whose local target is >= 0 and below its sum, the warp
// stages that chunk's weights in its tile, and one lane walks it.
__global__ void __launch_bounds__(kCdfWarps * 32)
k7_cdf_long_kernel(const int32_t* __restrict__ indices, const float* __restrict__ probs,
                   const int64_t* __restrict__ keys, int32_t* __restrict__ ids,
                   uint8_t* __restrict__ mask, int k, int64_t n_edges, K7Work work) {
  __shared__ float tile[kCdfWarps][32][33];
  __shared__ float s_sums[2 * kCdfSmemChunks];
  __shared__ unsigned s_j;
  __shared__ float s_total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_long = work.hdr->n_long;
  for (;;) {
    if (threadIdx.x == 0) s_j = atomicAdd(&work.hdr->queue, 1u);
    __syncthreads();
    const int64_t j = s_j;
    if (j >= n_long) break;
    const int64_t b = work.lrow[j], start = work.lstart[j];
    const int32_t deg = (int32_t)(work.lunits[j + 1] - work.lunits[j]);
    const int32_t nch = (deg + kChunk - 1) / kChunk;
    const bool in_smem = nch <= kCdfSmemChunks;
    const float* w = probs + start;
    if (!in_smem && nch > work.nchmax) {  // longer than max_degree promised: no table
      const float total = row_total_warp(w, deg, nch, lane);
      for (int t = warp * 32 + lane; t < k; t += kCdfWarps * 32) {
        const float target = __fmul_rn(bits_to_uniform((uint32_t)keys[b * k + t]), total);
        int32_t pick = 0;
        const bool take = total > 0.f && draw_untabled(w, deg, nch, target, pick);
        ids[b * k + t] = take ? indices[clamp_pos(start + pick, n_edges)] : kInvalid;
        mask[b * k + t] = take;
      }
      __syncthreads();  // s_j is the next row's
      continue;
    }
    float* ct = in_smem ? s_sums : work.cdf + (size_t)blockIdx.x * 2 * work.nchmax;  // chunk sums
    float* bef = ct + (in_smem ? kCdfSmemChunks : work.nchmax);                      // the chunks before each
    for (int32_t c0 = warp * 32; c0 < nch; c0 += kCdfWarps * 32) {
      float acc = 0.f, v[32];  // chunk c0 + lane's sum; one step's tile column
      auto load_step = [&](int step) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int32_t o = (c0 + i) * kChunk + step * 32 + lane;
          v[i] = c0 + i < nch && o < deg ? w[o] : 0.f;
        }
      };
      load_step(0);
      for (int step = 0; step < kChunk / 32; ++step) {
#pragma unroll
        for (int i = 0; i < 32; ++i) tile[warp][i][lane] = v[i];
        __syncwarp();
        if (step + 1 < kChunk / 32) load_step(step + 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, tile[warp][lane][i]);
        __syncwarp();
      }
      if (c0 + lane < nch) ct[c0 + lane] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int32_t c = 0; c < nch; c += 16) {  // 16 sums loaded ahead of their adds
        float s16[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) s16[q] = c + q < nch ? ct[c + q] : 0.f;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if (c + q < nch) {
            bef[c + q] = total;
            total = __fadd_rn(total, s16[q]);
          }
        }
      }
      s_total = total;
    }
    __syncthreads();
    const float total = s_total;
    float* stage = &tile[warp][0][0];
    for (int t = warp; t < k; t += kCdfWarps) {
      const float target = __fmul_rn(bits_to_uniform((uint32_t)keys[b * k + t]), total);
      int32_t c_hit = -1;
      for (int32_t c0 = 0; c0 < nch && c_hit < 0; c0 += 32) {
        const int32_t c = c0 + lane;
        bool q = false;
        if (c < nch) {
          const float local = __fsub_rn(target, bef[c]);
          q = local >= 0.f && ct[c] > local;
        }
        const unsigned bal = __ballot_sync(kFull, q);
        if (bal) c_hit = c0 + __ffs(bal) - 1;
      }
      const int32_t i0 = c_hit * kChunk;
      const int32_t len = c_hit < 0 ? 0 : (deg - i0 < kChunk ? deg - i0 : kChunk);
      for (int32_t q = lane; q < len; q += 32) stage[q] = w[i0 + q];
      __syncwarp();
      if (lane == 0) {
        int32_t pick = 0;
        const bool found = c_hit >= 0 && walk_chunk(stage, 0, len, __fsub_rn(target, bef[c_hit]), pick);
        const bool take = total > 0.f && found;  // a long row's seed is valid
        ids[b * k + t] = take ? indices[clamp_pos(start + i0 + pick, n_edges)] : kInvalid;
        mask[b * k + t] = take;
      }
      __syncwarp();
    }
    __syncthreads();  // the sums, the tiles and s_j are the next row's
  }
}

// K8's choices, settable at build time (-D) so that scripts/bench_k8.py
// --variants can time them against each other
#ifndef DG_K8_REG_MAX_K
#define DG_K8_REG_MAX_K 32  // k up to this keeps a long row's picks in registers (0: the shared set for every k)
#endif
#ifndef DG_K8_PAIRED
#define DG_K8_PAIRED 1  // 0: alias_idx only after a rejection, a short row's key only after a positive weight
#endif
#ifndef DG_K8_PREFETCH
#define DG_K8_PREFETCH 1  // 0: a row's first bits load after its indptr pair
#endif
constexpr int kK8RegMaxK = DG_K8_REG_MAX_K;
static_assert(kK8RegMaxK >= 0 && kK8RegMaxK <= 32, "the register list holds at most a lane an entry");
constexpr unsigned long long kSetEmpty = ~0ull;  // an empty slot of K8's set (a value is below 2^32)

// K8's lanes a row: with replacement the least of 8, 16 and 32 that holds
// k; without, a warp.
inline int k8_group(int k, int replace) { return replace ? (k <= 8 ? 8 : (k <= 16 ? 16 : 32)) : 32; }

// log2 of K8's set slots: the least power of two >= 2k (0 when the picks
// stay in registers).
inline int k8_set_log(int k) {
  if (k <= kK8RegMaxK) return 0;
  int l = 1;
  while ((1 << l) < 2 * k) ++l;
  return l;
}

// A group's shared memory without replacement, a multiple of 8 bytes: a
// short row's 2k keys, or in the set's place (which is larger) the set and
// then the picks.
inline size_t k8_group_bytes(int k, int replace) {
  if (replace) return 0;
  const int l = k8_set_log(k);
  const size_t bytes = l ? ((size_t)8 << l) + (size_t)4 * k : (size_t)8 * k;
  return (bytes + 7) & ~(size_t)7;
}

// One alias draw from the bits (x0, x1): an offset within the row.
__device__ __forceinline__ int32_t alias_draw(uint32_t x0, uint32_t x1, int32_t deg, int64_t start,
                                              const float* __restrict__ alias_prob,
                                              const int32_t* __restrict__ alias_idx,
                                              int64_t n_edges) {
  const uint32_t j = x0 % (uint32_t)(deg > 1 ? deg : 1);
  const int64_t pos = clamp_pos(start + (int64_t)j, n_edges);
  const float p = alias_prob[pos];
#if DG_K8_PAIRED
  const int32_t a = alias_idx[pos];
  return bits_to_uniform(x1) < p ? (int32_t)j : a;
#else
  return bits_to_uniform(x1) < p ? (int32_t)j : alias_idx[pos];
#endif
}

// The position of the n-th set bit of m (from 0), which has more than n.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int p = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1)
    if (__popc(m & ((1u << (p + w)) - 1u)) <= n) p += w;
  return p;
}

// K8's set: open addressing, linear probing, 2^lg slots, at most half
// full, so a lookup ends at the value or an empty slot.
__device__ __forceinline__ unsigned set_slot(int32_t d, int lg) {
  return ((uint32_t)d * kGolden) >> (32 - lg);
}

__device__ __forceinline__ bool set_has(const unsigned long long* set, int lg, int32_t d) {
  const unsigned long long v = (uint32_t)d;
  const unsigned m = (1u << lg) - 1u;
  for (unsigned i = set_slot(d, lg);; i = (i + 1) & m) {
    const unsigned long long e = set[i];
    if (e == v) return true;
    if (e == kSetEmpty) return false;
  }
}

__device__ __forceinline__ void set_add(unsigned long long* set, int lg, int32_t d) {
  const unsigned long long v = (uint32_t)d;
  const unsigned m = (1u << lg) - 1u;
  for (unsigned i = set_slot(d, lg);; i = (i + 1) & m)
    if (atomicCAS(set + i, kSetEmpty, v) == kSetEmpty) return;
}

// K8: the alias sampler, a group of G lanes a row (header).
template <typename IP>
__global__ void __launch_bounds__(kMaxWarps * 32)
sample_biased_alias_kernel(
    const IP* __restrict__ indptr, const int32_t* __restrict__ indices,
    const float* __restrict__ probs, const float* __restrict__ alias_prob,
    const int32_t* __restrict__ alias_idx, const int32_t* __restrict__ seeds,
    const int64_t* __restrict__ bits, const int64_t* __restrict__ gkeys,
    int32_t* __restrict__ ids, uint8_t* __restrict__ mask, int32_t* __restrict__ shortfall,
    int64_t B, int k, int64_t n_nodes, int64_t n_edges, int replace, int G, int set_log,
    int group_bytes) {
  extern __shared__ unsigned long long smem_g[];
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), base = lane - gl;
  const unsigned gmask = (G == 32 ? kFull : (1u << G) - 1u) << base;
  const unsigned below = (1u << lane) - 1u;
  const int gpb = blockDim.x / G;
  const int T = replace ? k : 4 * k, D = 2 * k;
  const int n0 = min(G, T);  // the first round's draws, or the first slots with replacement
  char* gs = reinterpret_cast<char*>(smem_g) + (size_t)(threadIdx.x / G) * group_bytes;
  float* sk = reinterpret_cast<float*>(gs);                               // a short row's keys
  unsigned long long* set = reinterpret_cast<unsigned long long*>(gs);    // a long row's set (k > 32)
  int32_t* picks = reinterpret_cast<int32_t*>(gs + ((size_t)8 << set_log));  // ... and its picks
  int32_t short_sum = 0;  // this group's shortfall, at its lane 0
  for (int64_t b = (int64_t)blockIdx.x * gpb + threadIdx.x / G; b < B; b += (int64_t)gridDim.x * gpb) {
    const int64_t* b0 = bits + b * T;
    const int64_t* b1 = b0 + B * (int64_t)T;  // bits[1] follows bits[0]
    const int32_t seed = seeds[b];
    uint32_t x0 = 0, x1 = 0;  // the bits of draw gl, loaded beside the indptr pair
#if DG_K8_PREFETCH
    if (seed != kInvalid && gl < n0) {
      x0 = (uint32_t)b0[gl];
      x1 = (uint32_t)b1[gl];
    }
#endif
    int64_t start;
    int32_t deg;
    bool valid;
    row_extent(indptr, seed, n_nodes, start, deg, valid);
    if (replace) {
      const bool take = valid && deg > 0;
      for (int t = gl; t < k; t += G) {
        int32_t id = kInvalid;
        if (take) {
          if (!DG_K8_PREFETCH || t != gl) {
            x0 = (uint32_t)b0[t];
            x1 = (uint32_t)b1[t];
          }
          id = indices[clamp_pos(start + alias_draw(x0, x1, deg, start, alias_prob, alias_idx, n_edges),
                                 n_edges)];
        }
        ids[b * k + t] = id;
        mask[b * k + t] = take;
      }
      continue;
    }
    if (deg == 0) {  // no edge, or a padded seed: every slot masked
      for (int j = gl; j < k; j += G) {
        ids[b * k + j] = kInvalid;
        mask[b * k + j] = 0;
      }
      continue;
    }
    if (deg <= D) {  // the exact Gumbel top-k over the short row
      for (int o = gl; o < D; o += G) {
        float key = neg_inf();
        if (o < deg) {
          const float w = probs[clamp_pos(start + o, n_edges)];
#if DG_K8_PAIRED
          const uint32_t g = (uint32_t)gkeys[b * D + o];
          if (w > 0.f) key = gumbel_key(g, w);
#else
          if (w > 0.f) key = gumbel_key((uint32_t)gkeys[b * D + o], w);
#endif
        }
        sk[o] = key;
      }
      __syncwarp(gmask);
      for (int o = gl; o < D; o += G) {
        const float ko = sk[o];
        int rank = 0;
        for (int j = 0; j < D; ++j) {
          const float kj = sk[j];
          rank += (kj > ko) || (kj == ko && j < o);
        }
        if (rank < k) {
          const bool take = ko > neg_inf();
          ids[b * k + rank] = take ? indices[clamp_pos(start + o, n_edges)] : kInvalid;
          mask[b * k + rank] = take;
        }
      }
      __syncwarp(gmask);  // the keys are the next row's
      continue;
    }
    // a long row: its first k distinct draws, read in rounds up to the k-th
    const bool reg = set_log == 0;
    int32_t kept = 0;  // with reg: lane gl holds pick gl
    if (!reg) {
      for (int i = gl; i < (1 << set_log); i += G) set[i] = kSetEmpty;
      __syncwarp(gmask);
    }
    int got = 0, t0 = 0;
    do {
      const int n = min(G, T - t0);
      const bool act = gl < n;
      int32_t d = -1;
      if (act) {
        if (!DG_K8_PREFETCH || t0 != 0) {
          x0 = (uint32_t)b0[t0 + gl];
          x1 = (uint32_t)b1[t0 + gl];
        }
        d = alias_draw(x0, x1, deg, start, alias_prob, alias_idx, n_edges);
      }
      const unsigned actm = __ballot_sync(gmask, act);
      // the lowest active lane of its value's lanes is the round's first ...
      const unsigned same = __match_any_sync(gmask, d) & actm;
      bool first = act && (same & below) == 0;
      // ... and the row's first unless an earlier round kept the value
      if (reg) {
        for (int i = 0; i < got; ++i) {
          const int32_t e = __shfl_sync(gmask, kept, base + i);
          first = first && e != d;
        }
      } else if (first) {
        first = !set_has(set, set_log, d);
      }
      const unsigned bal = __ballot_sync(gmask, first);
      const int keep = min(__popc(bal), k - got);  // the new firsts of rank < k
      if (reg) {  // lane got + q takes the q-th new first
        const int q = gl - got;
        const bool dest = q >= 0 && q < keep;
        const int32_t v = __shfl_sync(gmask, d, dest ? nth_set(bal, q) : lane);
        if (dest) kept = v;
      } else {
        const int rank = got + __popc(bal & below);
        if (first && rank < k) {
          picks[rank] = d;
          set_add(set, set_log, d);
        }
        __syncwarp(gmask);
      }
      got += keep;
      t0 += n;
    } while (got < k && t0 < T);
    for (int j = gl; j < k; j += G) {
      const bool take = j < got;
      const int32_t off = reg ? kept : (take ? picks[j] : 0);
      ids[b * k + j] = take ? indices[clamp_pos(start + off, n_edges)] : kInvalid;
      mask[b * k + j] = take;
    }
    if (!reg) __syncwarp(gmask);  // the set and picks are the next row's
    if (gl == 0) short_sum += k - got;
  }
  const int total = __reduce_add_sync(kFull, short_sum);
  if (lane == 0 && total) atomicAdd(shortfall, total);
}

// Warps per block such that their shared memory fits the default 48 KB
// (less what the kernel declares statically).
inline int warps_for(size_t smem_per_warp, int most = kMaxWarps, size_t fixed = 0) {
  if (smem_per_warp == 0) return most;
  const int w = (int)((kSmemBudget - fixed) / smem_per_warp);
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
                         const K7Layout& L, void* workspace, cudaStream_t stream) {
  const int scan = L.total > 0;  // rows can be long: kernels 2-3 (or 2') take them
  const K7Work work = scan ? k7_bind(L, workspace) : K7Work{};
  const size_t per_warp = replace ? (size_t)2 * kWarpChunks * sizeof(float) : (size_t)2 * k * sizeof(float);
  const int wpb = warps_for(per_warp, kRowWarps, kScanSmem);
  // the row blocks and the scan block all fit on the card at once: a block
  // left for a second wave would double the kernel's time
  const int64_t resident = L.sms * (2 * kRowWarps / wpb) - scan;
  const unsigned row_blocks = grid_for(B, wpb) < resident ? grid_for(B, wpb) : (unsigned)resident;
  k7_rows_kernel<IP><<<row_blocks + scan, wpb * 32, wpb * per_warp, stream>>>(
      static_cast<const IP*>(indptr), indices, probs, seeds, keys, ids, mask, B, k, n_nodes, n_edges,
      replace, scan, work);
  if (!scan) return (int)cudaGetLastError();
  if (replace) {
    k7_cdf_long_kernel<<<(unsigned)L.Gb, kCdfWarps * 32, 0, stream>>>(indices, probs, keys, ids, mask, k,
                                                                     n_edges, work);
  } else {
    const size_t list = (size_t)2 * k * sizeof(float);
    const int spb = warps_for(list, kSliceWarps);
    k7_slices_kernel<<<(unsigned)((L.W + spb - 1) / spb), spb * 32, spb * list, stream>>>(
        indices, probs, keys, ids, mask, k, n_edges, work);
    const int mpb = warps_for((size_t)k * sizeof(int32_t), kMergeWarps);
    k7_merge_kernel<<<(unsigned)((L.W + mpb - 1) / mpb), mpb * 32, mpb * k * sizeof(int32_t), stream>>>(
        indices, ids, mask, k, n_edges, work);
  }
  return (int)cudaGetLastError();
}

template <typename IP>
int launch_sample_biased_alias(const void* indptr, const int32_t* indices, const float* probs,
                               const float* alias_prob, const int32_t* alias_idx,
                               const int32_t* seeds, const int64_t* bits, const int64_t* gkeys,
                               int32_t* ids, uint8_t* mask, int32_t* shortfall, int64_t B, int k,
                               int64_t n_nodes, int64_t n_edges, int replace, int sms,
                               cudaStream_t stream) {
  const int G = k8_group(k, replace), per_warp = 32 / G;
  const int set_log = replace ? 0 : k8_set_log(k);
  const size_t group_bytes = k8_group_bytes(k, replace);
  const int64_t warps = (B + per_warp - 1) / per_warp;
  // a warp on every SM before a block takes a second
  const int most = warps_for(group_bytes * per_warp);
  const int64_t spread = (warps + sms - 1) / sms;
  const int wpb = (int)(spread < most ? spread : most);
  sample_biased_alias_kernel<IP><<<grid_for(warps, wpb), wpb * 32, wpb * per_warp * group_bytes, stream>>>(
      static_cast<const IP*>(indptr), indices, probs, alias_prob, alias_idx, seeds, bits, gkeys,
      ids, mask, shortfall, B, k, n_nodes, n_edges, replace, G, set_log, (int)group_bytes);
  return (int)cudaGetLastError();
}

// ---- K10: dropout ----------------------------------------------------------

constexpr float kUnit = 5.9604644775390625e-08f;   // 2^-24 (prng.py bits_to_uniform)
constexpr float kFloor = 2.98023223876953125e-08f;  // 2^-25, the uniform's floor

// Element (row key, col) is kept: prng.py dropout_keep's uniform of
// mix32(key ^ col * golden), below keep_prob.  (bits >> 8) < 2^24 converts
// to float exactly, and the product with 2^-24 is exact.
__device__ __forceinline__ bool drop_keep(uint32_t key, uint32_t col, float keep_prob) {
  const uint32_t bits = mix32(key ^ (col * kGolden));
  return fmaxf((float)(bits >> 8) * kUnit, kFloor) < keep_prob;
}

constexpr int64_t kMaxDropoutElems = (int64_t)1 << 31;  // ops/dropout.py MAX_ELEMS

// An element's bits (Bits), or a 32-bit word of a 16-byte vector: one f32
// a word, or two bf16 (the low half first), as floats and back.  A bf16 is
// the high half of the float it rounds, so widening is a shift, and
// narrowing rounds to nearest even as torch's cast on the card does.
template <typename T>
struct Words;

template <>
struct Words<float> {
  using Bits = uint32_t;
  static constexpr int kPer = 1;
  __device__ static float get(uint32_t w, int) { return __uint_as_float(w); }
  __device__ static uint32_t put(float v, int) { return __float_as_uint(v); }
};

template <>
struct Words<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int kPer = 2;
  __device__ static float get(uint32_t w, int i) {
    return __uint_as_float(i ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static uint32_t put(float v, int i) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    return i ? b << 16 : b;
  }
};

__device__ __forceinline__ float drop_value(float x, bool keep, float scale) {
  return keep ? __fmul_rn(x, scale) : 0.0f;
}

// One thread per 16-byte vector of a row (H * sizeof(T) % 16 == 0, both
// pointers 16-byte aligned): 4 f32 or 8 bf16 elements, one row key.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_vec_kernel(const uint4* __restrict__ in, const int64_t* __restrict__ keys,
                   uint4* __restrict__ out, uint32_t n_vec, uint32_t vec_per_row, float keep_prob,
                   float scale) {
  constexpr int kVec = 16 / sizeof(T);
  using W = Words<T>;
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < n_vec; v += gridDim.x * kThreads) {
    const uint32_t r = v / vec_per_row;
    const uint32_t c0 = (uint32_t)((v - r * vec_per_row) * kVec);
    const uint32_t key = (uint32_t)keys[r];
    const uint4 x = in[v];
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t y = 0;
#pragma unroll
      for (int i = 0; i < W::kPer; ++i) {
        const bool keep = drop_keep(key, c0 + j * W::kPer + i, keep_prob);
        y |= W::put(drop_value(W::get(w[j], i), keep, scale), i);
      }
      w[j] = y;
    }
    out[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Any width or alignment: one thread per element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_scalar_kernel(const typename Words<T>::Bits* __restrict__ in, const int64_t* __restrict__ keys,
                      typename Words<T>::Bits* __restrict__ out, uint32_t n, uint32_t H, float keep_prob,
                      float scale) {
  using W = Words<T>;
  for (uint32_t e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    const uint32_t r = e / H;
    const bool keep = drop_keep((uint32_t)keys[r], e - r * H, keep_prob);
    out[e] = (typename W::Bits)W::put(drop_value(W::get(in[e], 0), keep, scale), 0);
  }
}

// At most 2^31 elements, so a 32-bit index and its grid-stride step (at
// most kMaxBlocks * kThreads) stay below 2^32.
template <typename T>
int launch_dropout(const void* in, const int64_t* keys, void* out, int64_t S, int64_t H, int vec,
                   float keep_prob, float scale, cudaStream_t stream) {
  using Bits = typename Words<T>::Bits;
  const int64_t n = S * H;
  if (vec != 1 && (vec != 16 / (int)sizeof(T) || (H * (int64_t)sizeof(T)) % 16 != 0 ||
                   (reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (vec > 1) {
    const int64_t n_vec = n / vec;
    dropout_vec_kernel<T><<<grid_for(n_vec, kThreads), kThreads, 0, stream>>>(
        static_cast<const uint4*>(in), keys, static_cast<uint4*>(out), (uint32_t)n_vec,
        (uint32_t)(H / vec), keep_prob, scale);
  } else {
    dropout_scalar_kernel<T><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
        static_cast<const Bits*>(in), keys, static_cast<Bits*>(out), (uint32_t)n, (uint32_t)H,
        keep_prob, scale);
  }
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

// K7's workspace: the bytes dg_sample_biased needs for B rows, k, a graph
// whose rows have at most max_degree edges, and the mode, on the current
// device (0 when max_degree <= 1024), written to *bytes.  Reads the
// device's SM count; launches nothing.
int dg_sample_biased_workspace(int64_t B, int k, int64_t max_degree, int replace, int64_t* bytes) {
  if (B < 0 || k < 1 || k > kMaxK || max_degree < 0 || bytes == nullptr)
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  *bytes = (int64_t)k7_layout(B, k, max_degree, replace, sms).total;
  return 0;
}

// K7.  indptr, indices, seeds, ids and mask as for K6; probs [n_edges]
// f32 weights (>= 0); keys int64 holding uint32 values, [B] (replace = 0:
// the row keys) or [B, k] (replace = 1: one per draw); max_degree the
// graph's longest row (a longer row stays exact, and costs O(deg) a draw
// with replacement); workspace of workspace_bytes >=
// dg_sample_biased_workspace's on the device (unread when that is 0).
// Needs n_nodes >= 1, n_edges >= 1 and 1 <= k <= 1024 (B may be 0).
int dg_sample_biased(const void* indptr, int indptr_int64, const int32_t* indices,
                     const float* probs, const int32_t* seeds, const int64_t* keys, int32_t* ids,
                     uint8_t* mask, int64_t B, int k, int64_t n_nodes, int64_t n_edges,
                     int replace, int64_t max_degree, void* workspace, int64_t workspace_bytes,
                     void* stream) {
  if (B < 0 || k < 1 || k > kMaxK || n_nodes <= 0 || n_edges <= 0 || max_degree < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const K7Layout L = k7_layout(B, k, max_degree, replace, sms);
  if (L.total > 0 && (workspace == nullptr || workspace_bytes < (int64_t)L.total))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (indptr_int64)
    return launch_sample_biased<int64_t>(indptr, indices, probs, seeds, keys, ids, mask, B, k,
                                         n_nodes, n_edges, replace, L, workspace, st);
  return launch_sample_biased<int32_t>(indptr, indices, probs, seeds, keys, ids, mask, B, k,
                                       n_nodes, n_edges, replace, L, workspace, st);
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
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (indptr_int64)
    return launch_sample_biased_alias<int64_t>(indptr, indices, probs, alias_prob, alias_idx,
                                               seeds, bits, gkeys, ids, mask, shortfall, B, k,
                                               n_nodes, n_edges, replace, sms, st);
  return launch_sample_biased_alias<int32_t>(indptr, indices, probs, alias_prob, alias_idx, seeds,
                                             bits, gkeys, ids, mask, shortfall, B, k, n_nodes,
                                             n_edges, replace, sms, st);
}

// K10.  in and out [S, H] contiguous, dtype 0 = float32, 1 = bfloat16;
// keys [S] int64 holding uint32 values; out = in * scale where kept, 0
// where dropped.  vec 1 takes the scalar kernel, 16 / sizeof(element) the
// vector kernel (H * sizeof(element) a multiple of 16 and both pointers
// 16-byte aligned, else cudaErrorInvalidValue).  S * H may be 0 and is at
// most kMaxDropoutElems (else cudaErrorInvalidValue).
int dg_dropout(const void* in, const int64_t* keys, void* out, int64_t S, int64_t H, int dtype,
               int vec, float keep_prob, float scale, void* stream) {
  if (S < 0 || H < 0 || (H > 0 && S > kMaxDropoutElems / H)) return (int)cudaErrorInvalidValue;
  if (S * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dropout<float>(in, keys, out, S, H, vec, keep_prob, scale, st);
    case 1: return launch_dropout<__nv_bfloat16>(in, keys, out, S, H, vec, keep_prob, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
