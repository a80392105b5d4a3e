// K1 (feature-row gather), K2 (the same gather through double-buffered
// row copies) and K3 (masked neighbour mean, forward and backward) for
// Hopper, sm_90a.
//
// Plain C interface, loaded with ctypes by dist_gnn_tpu_torch/ops/gather.py
// (built by dist_gnn_tpu_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// K1 dg_gather_rows: out[i] = table[idx[i]] for a row-major [N, row_bytes]
//   table and int32 idx.  Replaces dist_gnn_tpu/ops/gather_pallas.py
//   _gather_rows_chunk / _gather_rows_multi_chunk (kernels _gather_kernel,
//   _gather_multi_kernel).  No arithmetic: bound by device-memory bytes,
//   each distinct row read once plus the output written once.  Design: each
//   warp copies a run of kRunRows consecutive output rows.  Its lanes read
//   the run's ids in one coalesced load and share them by shuffles; the
//   run's output is one contiguous span, which the lanes fill with stores
//   of SV bytes (16 wherever the span's alignment allows: the main path's
//   200-byte bf16 rows start only 8-byte aligned, but a run of 32 of them
//   is 6,400 bytes, so each 16-byte store takes two 8-byte row loads), and
//   each lane issues the loads of kRunBatch stores, which lie in several
//   rows, before its first store, so many rows are in flight per lane and
//   none waits on another's id.  The stores are streaming (st.global.cs):
//   the output is read by the next kernel, not by this one, and should not
//   evict from L2 the table rows the dedup-free last hop repeats.  The load
//   width VEC and the store width SV are chosen here from the row size and
//   the addresses; the run and batch sizes were among the fastest of those
//   tried on an H100 at the main path's shape, in bf16 and f32 (PERF.md).
//   The TPU's F%128 and SMEM chunk limits are gone.
//
// K3 dg_gather_mean: out[s] = sum_{valid j} h[slots[s,j]] / max(cnt_s, 1),
//   rows with no valid slot give 0, no [S, k, F] intermediate.  Replaces
//   gather_pallas.py _gather_sum_chunk (kernel _gather_sum_kernel), which
//   redirected masked slots to an appended zero row; here masked slots are
//   skipped, so h is never copied.  Bound by bytes: the distinct valid rows
//   of h read once, slots and mask read once, the output written once.
//   Sums in f32 registers and writes each row once in the input dtype (the
//   Pallas kernel accumulated in the table dtype, so bf16 results differ
//   from it by rounding).  Design: one warp per destination row; the
//   lanes read the row's slots and mask side by side, a ballot names the
//   valid ones, and each lane loads its vector of 8 valid rows before it
//   adds any, so 8 loads per lane are in flight.  A k-major form for the
//   dedup-free first layer, reading slot j's rows as one span with no slot
//   table, was slower than this one at that layer on the H100 in each of
//   four designs (PERF.md), so every layer takes this one.
//
// K3 backward dg_gather_mean_bwd: d_h[r] = sum over the valid (s, j) with
//   slots[s,j] = r of d_out[s] / cnt_s.  The Pallas package has no backward
//   kernel for K3 (its SAGE differentiates the jnp mean through XLA); this
//   is the port's own.  Bound by bytes: d_out, slots and mask read once,
//   d_h written once.  Design: the gather form, from the slot table's
//   transpose (a CSR of each source row's valid flat slots s*k + j, built
//   by build_transpose, which dg_slot_transpose runs alone and
//   dg_gather_mean runs after K3 in the same call when the forward knows a
//   gradient will be needed).  The build moves well under a megabyte at
//   the SAGE layers, so its time is that of its launches and the memory
//   round trips between its phases: it is four kernels (zero, count, scan,
//   fill) and no memset, chained by programmatic dependent launch so that
//   each launches while the one before runs and waits only for its
//   results.  Also measured on the H100 and dropped, each slower than the
//   parent's memset and three plain launches at both SAGE layers or than
//   this form (PERF.md): one cooperative launch parted by grid-wide
//   barriers; one cluster of 8 blocks parted by the cluster's barrier;
//   count and fill with one atomic per warp for the lanes that name one
//   row (__match_any_sync); blocks of 1,024 threads.  Each row of d_h is
//   summed in f32 registers in increasing flat index and written once in
//   d_out's dtype, zeros where no slot names it: no f32 [cap, F] buffer, no
//   zero fill, no cast, no atomics on the features.  Rows named by up to 32
//   slots take one warp each (the lanes rank the entries by shuffles);
//   hub rows, which a power-law graph's sampled rows name hundreds of
//   times, take one block each, which orders the list through a bitmap of
//   the keys in shared memory, one window of 2^20 keys at a time, and
//   splits it over 32 warps, so no warp walks a hub's list alone.  The sum
//   is the same bits on every run, at any slot-table size.
//
// K2 dg_gather_rows_dma: the same out[i] = table[idx[i]] as K1, by
//   double-buffered row copies through shared memory.  Replaces
//   gather_pallas.py _gather_rows_dma_call (kernel _gather_dma_kernel),
//   which started B single-row DMAs into one of two VMEM stages, then the
//   next step's B, then waited on its own and wrote its [B, F] block.
//   Bound by bytes as K1 is.  Design: a persistent grid (as many blocks as
//   fit on the SMs at this shared-memory size) walks output tiles of B
//   consecutive rows, tile t += gridDim.x.  Two stages of B * row_bytes live
//   in dynamic shared memory.  For tile t+1 one warp per row issues cp.async
//   copies (16, 8 or 4-byte granules, the widest that divides the row and
//   the base pointers) into the free stage and commits them as one group;
//   cp.async.wait_group 1 then waits for tile t's group only, and the block
//   drains tile t's stage to out as one contiguous B * row_bytes span with
//   coalesced vector stores while tile t+1's copies are in flight.  Rows
//   only 2- or 1-byte aligned take ordinary loads into the stage (cp.async
//   has no smaller granule).  The TPU's f32-only rule, F % 128 assert, idx
//   padding to a multiple of B and 131072-id SMEM chunks are gone.  The
//   wrapper refuses a B whose two stages exceed the block's opt-in shared
//   memory (dg_smem_optin_bytes) before any launch.
//
// Out-of-range ids are clamped into the table (the callers pre-clip them,
// as with jnp.take), so a bad id can never read outside the allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int BYTES> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<1> { using T = unsigned char; };

constexpr int kThreads = 256;           // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// The widest vector (16, 8, 4, 2 or 1 bytes, never below one element) whose
// size divides `bytes` and both addresses, so no vector access is misaligned.
int vec_for(const void* a, const void* b, int64_t bytes, int elem) {
  const uint64_t bits = (uint64_t)(uintptr_t)a | (uint64_t)(uintptr_t)b | (uint64_t)bytes;
  int v = 16;
  while (v > elem && bits % v) v >>= 1;
  return v;
}

int64_t grid_for(int64_t rows) {
  int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// ---- K1 -------------------------------------------------------------------

constexpr int kRunRows = 32;  // output rows per warp run (at most 32: one id a lane)
constexpr int kRunBatch = 4;  // stores whose loads a lane issues before storing

template <int VEC, int SV>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const typename Raw<VEC>::T* __restrict__ table,
                   const int32_t* __restrict__ idx, unsigned char* __restrict__ out,
                   int64_t n_rows, int64_t L, int vpr) {
  using V = typename Raw<VEC>::T;
  using W = typename Raw<SV>::T;
  constexpr int P = SV / VEC;  // loads per store
  const int lane = threadIdx.x & 31;
  const int64_t row_bytes = (int64_t)vpr * VEC;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t run = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       run * kRunRows < L; run += n_warps) {
    const int64_t i0 = run * kRunRows;
    const int nr = (int)min64(kRunRows, L - i0);
    const int my = lane < nr ? (int)clamp_row(idx[i0 + lane], n_rows) : 0;
    const int units = nr * vpr;    // VEC-byte pieces of the span
    const int stores = units / P;  // whole SV-byte stores
    unsigned char* span = out + i0 * row_bytes;  // SV-aligned: kRunRows * row_bytes % SV == 0
    for (int s0 = 0; s0 < stores; s0 += 32 * kRunBatch) {
      V raw[kRunBatch][P];
#pragma unroll
      for (int u = 0; u < kRunBatch; ++u) {
        const int st = s0 + u * 32 + lane;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int unit = st * P + p;
          const int row = unit / vpr;
          const int r = __shfl_sync(kFull, my, row & 31);  // every lane shuffles
          if (st < stores) raw[u][p] = table[(int64_t)r * vpr + (unit - row * vpr)];
        }
      }
#pragma unroll
      for (int u = 0; u < kRunBatch; ++u) {
        const int st = s0 + u * 32 + lane;
        if (st < stores) {
          union {
            W w;
            V v[P];
          } pack;
#pragma unroll
          for (int p = 0; p < P; ++p) pack.v[p] = raw[u][p];
          __stcs(reinterpret_cast<W*>(span) + st, pack.w);  // st.global.cs
        }
      }
    }
    // a short last run may end inside a store: its last pieces one by one
    for (int unit = stores * P + lane; unit < units; unit += 32) {
      const int row = unit / vpr;
      const int64_t r = clamp_row(idx[i0 + row], n_rows);
      reinterpret_cast<V*>(span)[unit] = table[r * vpr + (unit - row * vpr)];
    }
  }
}

template <int VEC, int SV>
int launch_gather_rows(const void* table, const int32_t* idx, void* out, int64_t n_rows,
                       int64_t L, int64_t row_bytes, cudaStream_t stream) {
  const int64_t runs = (L + kRunRows - 1) / kRunRows;
  gather_rows_kernel<VEC, SV><<<(unsigned)grid_for(runs), kThreads, 0, stream>>>(
      static_cast<const typename Raw<VEC>::T*>(table), idx, static_cast<unsigned char*>(out),
      n_rows, L, (int)(row_bytes / VEC));
  return (int)cudaGetLastError();
}

// Store widths up to 4 loads (and 16 bytes) wide, so a lane's batch stays
// in 32 registers whatever the load width.
template <int VEC>
int dispatch_gather_rows(int sv, const void* table, const int32_t* idx, void* out, int64_t n_rows,
                         int64_t L, int64_t row_bytes, cudaStream_t stream) {
  constexpr int kMaxSV = VEC * 4 < 16 ? VEC * 4 : 16;
  if (sv > kMaxSV) sv = kMaxSV;
  switch (sv / VEC) {
    case 1: return launch_gather_rows<VEC, VEC>(table, idx, out, n_rows, L, row_bytes, stream);
    case 2:
      if constexpr (VEC * 2 <= 16)
        return launch_gather_rows<VEC, VEC * 2>(table, idx, out, n_rows, L, row_bytes, stream);
      return (int)cudaErrorInvalidValue;
    case 4:
      if constexpr (VEC * 4 <= 16)
        return launch_gather_rows<VEC, VEC * 4>(table, idx, out, n_rows, L, row_bytes, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- K2 -------------------------------------------------------------------

constexpr int kDmaThreads = 256;

// One VEC-byte copy from device memory into shared memory: cp.async for 4, 8
// and 16-byte granules (16 bypasses L1), an ordinary load and store below.
template <int VEC>
__device__ __forceinline__ void copy_to_stage(void* smem_dst, const void* src) {
  if constexpr (VEC >= 4) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
    if constexpr (VEC == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
                   "n"(VEC));
    }
  } else {
    using V = typename Raw<VEC>::T;
    *static_cast<V*>(smem_dst) = *static_cast<const V*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the row copies of tile t (rows [tB, tB + n)) into one stage: one
// warp per row, lanes across the row's VEC-byte granules.
template <int VEC>
__device__ __forceinline__ void issue_tile(unsigned char* stage,
                                           const unsigned char* __restrict__ table,
                                           const int32_t* __restrict__ idx,
                                           int64_t n_rows, int64_t first, int n,
                                           int64_t row_bytes, int vpr) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < n; j += kDmaThreads / 32) {
    const int64_t r = clamp_row(idx[first + j], n_rows);
    const unsigned char* src = table + r * row_bytes;
    unsigned char* dst = stage + (int64_t)j * row_bytes;
    for (int v = lane; v < vpr; v += 32) copy_to_stage<VEC>(dst + v * VEC, src + v * VEC);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kDmaThreads)
gather_rows_dma_kernel(const unsigned char* __restrict__ table,
                       const int32_t* __restrict__ idx,
                       unsigned char* __restrict__ out, int64_t n_rows, int64_t L,
                       int64_t row_bytes, int B) {
  using V = typename Raw<VEC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages[2] = {smem, smem + (int64_t)B * row_bytes};
  const int vpr = (int)(row_bytes / VEC);
  const int64_t n_tiles = (L + B - 1) / B;
  int64_t t = blockIdx.x;
  if (t >= n_tiles) return;
  auto rows_of = [&](int64_t tile) {
    const int64_t left = L - tile * B;
    return (int)(left < B ? left : B);
  };
  issue_tile<VEC>(stages[0], table, idx, n_rows, t * B, rows_of(t), row_bytes, vpr);
  cp_async_commit();
  int buf = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const int64_t next = t + gridDim.x;
    // the free stage was drained in the previous iteration, before its
    // closing barrier
    if (next < n_tiles)
      issue_tile<VEC>(stages[buf ^ 1], table, idx, n_rows, next * B, rows_of(next),
                      row_bytes, vpr);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait_one();  // tile t's group has landed (this thread's copies)
    __syncthreads();      // ... and every other thread's
    const int64_t n_vec = (int64_t)rows_of(t) * vpr;
    const V* src = reinterpret_cast<const V*>(stages[buf]);
    V* dst = reinterpret_cast<V*>(out + t * B * row_bytes);
    for (int64_t v = threadIdx.x; v < n_vec; v += kDmaThreads) dst[v] = src[v];
    __syncthreads();  // the stage is free for tile t + 2's copies
    buf ^= 1;
  }
}

template <int VEC>
int launch_gather_rows_dma(const void* table, const int32_t* idx, void* out,
                           int64_t n_rows, int64_t L, int64_t row_bytes, int B,
                           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)B * (size_t)row_bytes;
  auto kernel = gather_rows_dma_kernel<VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDmaThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (L + B - 1) / B;
  const int64_t resident = (int64_t)n_sm * per_sm;
  const unsigned grid = (unsigned)(n_tiles < resident ? n_tiles : resident);
  kernel<<<grid, kDmaThreads, smem, stream>>>(static_cast<const unsigned char*>(table), idx,
                                              static_cast<unsigned char*>(out), n_rows, L,
                                              row_bytes, B);
  return (int)cudaGetLastError();
}

// ---- K3 -------------------------------------------------------------------

constexpr int kSlotBatch = 8;   // row loads a lane keeps in flight

// The slot form: one warp per destination row.  The lanes read the row's
// slots and mask side by side (lane j: slot j), a ballot gives the valid
// slots, and the warp walks them in order kSlotBatch at a time, each lane
// loading its vector of every row of the batch before it adds any, so a
// lane has up to kSlotBatch loads in flight.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_mean_kernel(const T* __restrict__ h, const int32_t* __restrict__ slots,
                   const uint8_t* __restrict__ mask, T* __restrict__ out, int64_t cap,
                   int64_t S, int k, int F) {
  using V = typename Raw<VEC>::T;
  constexpr int E = VEC / (int)sizeof(T);  // elements per lane vector
  const int nvec = F / E;
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < S; s += n_warps) {
    const int32_t* srow = slots + s * k;
    const uint8_t* mrow = mask + s * k;
    int cnt = 0;
    for (int j0 = 0; j0 < k; j0 += 32)
      cnt += __popc(__ballot_sync(kFull, j0 + lane < k && mrow[j0 + lane]));
    const float denom = (float)(cnt > 1 ? cnt : 1);
    V* orow = reinterpret_cast<V*>(out + s * F);
    for (int v0 = 0; v0 < nvec; v0 += 32) {
      const int v = v0 + lane;
      const bool live = v < nvec;  // every lane takes part in the shuffles
      float acc[E];
#pragma unroll
      for (int q = 0; q < E; ++q) acc[q] = 0.f;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const bool valid = j0 + lane < k && mrow[j0 + lane];
        const int r = valid ? (int)clamp_row(srow[j0 + lane], cap) : 0;
        unsigned bits = __ballot_sync(kFull, valid);
        while (bits) {  // the same bits in every lane
          V raw[kSlotBatch];
          int n = 0;
#pragma unroll
          for (int u = 0; u < kSlotBatch; ++u) {
            if (bits) {
              const int src = __ffs(bits) - 1;
              bits &= bits - 1;
              const int64_t row = __shfl_sync(kFull, r, src);
              if (live) raw[u] = reinterpret_cast<const V*>(h + row * F)[v];
              n = u + 1;
            }
          }
#pragma unroll
          for (int u = 0; u < kSlotBatch; ++u) {
            if (u < n && live) {
              const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
              for (int q = 0; q < E; ++q) acc[q] += to_float(e[q]);
            }
          }
        }
      }
      if (live) {
        V res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int q = 0; q < E; ++q) o[q] = from_float<T>(acc[q] / denom);
        orow[v] = res;
      }
    }
  }
}

template <typename T, int VEC>
int launch_gather_mean(const void* h, const int32_t* slots, const uint8_t* mask, void* out,
                       int64_t cap, int64_t S, int k, int F, cudaStream_t stream) {
  gather_mean_kernel<T, VEC><<<(unsigned)grid_for(S), kThreads, 0, stream>>>(
      static_cast<const T*>(h), slots, mask, static_cast<T*>(out), cap, S, k, F);
  return (int)cudaGetLastError();
}

// ---- K3 backward: the slot table's transpose, then one gather per row -----

constexpr int kScanThreads = 1024;  // rows a block of the transpose's scan takes; 32 warps

constexpr int kLightMax = 32;  // lists up to this long: one warp a row, in registers
constexpr int kLightBatch = 4;  // row loads a lane of the light kernel keeps in flight

// The transpose's workspace (the wrapper allocates cap + 1 + 2 n + S +
// 4 * (cap + 1) int32, n = S * k): what the backward reads first, then
// scratch.
struct TransposeWs {
  int32_t* offsets;     // [cap + 1]: row r's list is entries[offsets[r], offsets[r + 1])
  int32_t* entries;     // [n]: flat slots s*k + j, valid ones only, by row
  float* entry_den;     // [n]: the divisor of each entry's row s, beside entries (a hub
                        // row's span: the backward's ordered list, as int32)
  float* den;           // [S]: max(cnt_s, 1), the mean's divisor of row s
  int32_t* counts;      // [cap] per-row counts (the fill counts them back to 0), then the
                        // scan's ticket [1]
  int32_t* n_heavy;     // rows whose list is longer than kLightMax
  int32_t* local;       // [cap] exclusive prefix within each kScanThreads range of rows
  int32_t* range_sums;  // [ranges + 1] each range's sum, then (as its prefix) what comes
                        // before it; ranges = ceil(cap / kScanThreads)
  int32_t* heavy_rows;  // [cap]: the n_heavy rows, in no fixed order
};

TransposeWs transpose_ws(int32_t* ws, int64_t cap, int64_t S, int k) {
  TransposeWs w;
  w.offsets = ws;
  w.entries = ws + cap + 1;
  w.entry_den = reinterpret_cast<float*>(w.entries + S * k);
  w.den = w.entry_den + S * k;
  w.counts = reinterpret_cast<int32_t*>(w.den + S);
  w.n_heavy = w.counts + cap + 1;
  w.local = w.n_heavy + 1;
  w.range_sums = w.local + cap;
  w.heavy_rows = w.range_sums + (cap + kScanThreads - 1) / kScanThreads + 1;
  return w;
}

// Exclusive scan of one int per thread over a block of kScanThreads;
// *total gets the block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x, int32_t* warp_total,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();  // warp_total is free
  if (lane == 31) warp_total[w] = inc;
  __syncthreads();
  if (w == 0) {
    int32_t y = warp_total[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    warp_total[lane] = y;
  }
  __syncthreads();
  *total = warp_total[31];
  return inc - x + (w > 0 ? warp_total[w - 1] : 0);
}

// The build: four kernels, zero, count, scan and fill, each launched with
// programmatic stream serialisation (launch_chained): it
// may be launched as the one before drains, and it waits before its first
// access to memory until that one has finished and its writes are
// visible, so the stream keeps the order of plain launches without the
// gap between them.  (Letting the next one launch as soon as a kernel
// starts, by griddepcontrol.launch_dependents, was no faster on the
// H100.)  The scan's blocks take kScanThreads rows each; the last to
// finish (by the ticket) turns the range sums into prefixes in place.

// Wait until the grid before this one on the stream has finished and its
// writes are visible (what cudaGridDependencySynchronize() does; at once
// after a plain launch).
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
transpose_zero_kernel(TransposeWs w, int64_t cap) {
  wait_for_previous_grid();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i <= cap;
       i += (int64_t)gridDim.x * blockDim.x)
    w.counts[i] = 0;  // and the ticket
  if (blockIdx.x == 0 && threadIdx.x == 0) *w.n_heavy = 0;
}

// Count: one per valid slot on its source row's count; and each row s's
// divisor max(cnt_s, 1).
__global__ void __launch_bounds__(kThreads)
transpose_count_kernel(const int32_t* __restrict__ slots, const uint8_t* __restrict__ mask,
                       TransposeWs w, int64_t S, int k, int64_t cap) {
  wait_for_previous_grid();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t e = tid; e < S * k; e += stride)
    if (mask[e]) atomicAdd(w.counts + clamp_row(slots[e], cap), 1);
  for (int64_t s = tid; s < S; s += stride) {
    int c = 0;
    for (int j = 0; j < k; ++j) c += mask[s * k + j] != 0;
    w.den[s] = (float)(c > 1 ? c : 1);
  }
}

__global__ void __launch_bounds__(kScanThreads)
transpose_scan_kernel(TransposeWs w, int64_t cap) {
  __shared__ int32_t warp_total[32];
  __shared__ bool last;
  wait_for_previous_grid();
  const int64_t i = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  int32_t total;
  const int32_t ex = block_exclusive_scan(i < cap ? w.counts[i] : 0, warp_total, &total);
  if (i < cap) w.local[i] = ex;
  if (threadIdx.x == 0) {
    w.range_sums[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(w.counts + cap), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  volatile int32_t* sums = w.range_sums;
  int32_t carry = 0;
  for (int64_t b0 = 0; b0 < gridDim.x; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    int32_t sum;
    const int32_t ex = block_exclusive_scan(b < gridDim.x ? sums[b] : 0, warp_total, &sum);
    if (b < gridDim.x) sums[b] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) sums[gridDim.x] = carry;
}

// Fill: the final offsets and the heavy rows (thread i <= cap), and each
// valid slot's flat index s*k + j, with its row's divisor, in its source
// row's list (thread e < n).  Row r's list begins at local[r] plus its
// range's prefix; its count counts down to 0 as its places are taken, so
// the order within a list is the atomics' (the backward sorts).
__global__ void __launch_bounds__(kThreads)
transpose_fill_kernel(const int32_t* __restrict__ slots, const uint8_t* __restrict__ mask,
                      TransposeWs w, int64_t S, int k, int64_t cap, int64_t ranges) {
  wait_for_previous_grid();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t total = w.range_sums[ranges];
  for (int64_t i = tid; i <= cap; i += stride) {
    const int32_t start = i < cap ? w.local[i] + w.range_sums[i / kScanThreads] : total;
    w.offsets[i] = start;
    if (i < cap) {
      const int32_t end =
          i + 1 < cap ? w.local[i + 1] + w.range_sums[(i + 1) / kScanThreads] : total;
      if (end - start > kLightMax) w.heavy_rows[atomicAdd(w.n_heavy, 1)] = (int32_t)i;
    }
  }
  for (int64_t e = tid; e < S * k; e += stride) {
    if (!mask[e]) continue;
    const int64_t r = clamp_row(slots[e], cap);
    const int32_t pos = w.local[r] + w.range_sums[r / kScanThreads] + atomicSub(w.counts + r, 1) - 1;
    w.entries[pos] = (int32_t)e;
    w.entry_den[pos] = w.den[(int32_t)e / k];
  }
}

template <typename... Params, typename... Args>
cudaError_t launch_chained(void (*kernel)(Params...), int64_t blocks, int threads, cudaStream_t st,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(blocks > 0 ? blocks : 1));
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The slot table's transpose into ws (cap >= 1): four launches, no memset.
int build_transpose(const int32_t* slots, const uint8_t* mask, int64_t cap, int64_t S, int k,
                    int32_t* ws, cudaStream_t st) {
  const TransposeWs w = transpose_ws(ws, cap, S, k);
  const int64_t ranges = (cap + kScanThreads - 1) / kScanThreads;
  const int64_t rows_blocks = min64((cap + kThreads) / kThreads, kMaxBlocks);
  const int64_t slot_blocks = min64((S * k + kThreads - 1) / kThreads, kMaxBlocks);
  const int64_t fill_blocks = slot_blocks > rows_blocks ? slot_blocks : rows_blocks;
  cudaError_t err = launch_chained(transpose_zero_kernel, rows_blocks, kThreads, st, w, cap);
  if (err == cudaSuccess)
    err = launch_chained(transpose_count_kernel, slot_blocks, kThreads, st, slots, mask, w, S, k,
                         cap);
  if (err == cudaSuccess)
    err = launch_chained(transpose_scan_kernel, ranges, kScanThreads, st, w, cap);
  if (err == cudaSuccess)
    err = launch_chained(transpose_fill_kernel, fill_blocks, kThreads, st, slots, mask, w, S, k,
                         cap, ranges);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// d_h[r] = sum over row r's list, in increasing flat index, of
// d_out[s] / cnt_s, in f32, written once in d_out's dtype (rows no slot
// names get zeros).  Two kernels share the rows by list length.
//
// Rows with at most kLightMax entries: one warp a row.  Each lane takes one
// entry and its row's divisor (stored beside it, so both come in one
// round trip), and ranks it among the others by shuffles; the warp then
// walks the entries in rank order, kLightBatch loads in flight per lane
// (most rows have one or two entries, and fewer registers let more rows
// be in flight).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_mean_bwd_kernel(const T* __restrict__ d_out, const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ entries, const float* __restrict__ entry_den,
                       T* __restrict__ d_h, int64_t cap, int k, int F) {
  using V = typename Raw<VEC>::T;
  constexpr int E = VEC / (int)sizeof(T);
  constexpr int kNone = 0x7fffffff;
  const int nvec = F / E;
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < cap; r += n_warps) {
    const int b = offsets[r];
    const int n = offsets[r + 1] - b;
    if (n > kLightMax) continue;  // the heavy kernel's row
    const int key = lane < n ? entries[b + lane] : kNone;
    const float den = lane < n ? entry_den[b + lane] : 1.f;
    const int s = lane < n ? key / k : 0;
    int rank = 0;  // keys are distinct; lanes without an entry rank n
    for (int t = 0; t < n; ++t) rank += __shfl_sync(kFull, key, t) < key;
    V* orow = reinterpret_cast<V*>(d_h + r * F);
    for (int v0 = 0; v0 < nvec; v0 += 32) {
      const int v = v0 + lane;
      const bool live = v < nvec;
      float acc[E];
#pragma unroll
      for (int q = 0; q < E; ++q) acc[q] = 0.f;
      for (int t0 = 0; t0 < n; t0 += kLightBatch) {
        V raw[kLightBatch];
        float dn[kLightBatch];
#pragma unroll
        for (int u = 0; u < kLightBatch; ++u) {
          if (t0 + u < n) {
            const int src = __ffs(__ballot_sync(kFull, rank == t0 + u)) - 1;
            const int64_t row = __shfl_sync(kFull, s, src);
            dn[u] = __shfl_sync(kFull, den, src);
            if (live) raw[u] = reinterpret_cast<const V*>(d_out + row * F)[v];
          }
        }
#pragma unroll
        for (int u = 0; u < kLightBatch; ++u) {
          if (t0 + u < n && live) {
            const T* x = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
            for (int q = 0; q < E; ++q) acc[q] += to_float(x[q]) / dn[u];
          }
        }
      }
      if (live) {
        V res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int q = 0; q < E; ++q) o[q] = from_float<T>(acc[q]);
        orow[v] = res;
      }
    }
  }
}

constexpr int kHeavyThreads = 1024;  // 32 warps
constexpr int kHeavyWords = 32768;   // bitmap words: one window of 2^20 keys
constexpr int64_t kWindowKeys = (int64_t)kHeavyWords * 32;

// Rows with longer lists (hubs: a node that many sampled rows name): one
// block a row, persistent blocks walking the heavy rows.  The block writes
// the row's list in increasing order into sorted_entries, the row's span of
// the entry divisors, which only the light kernel's rows read: window by
// window of kWindowKeys keys, it marks the window's keys in a bitmap in shared
// memory, then a block-wide scan of its words' bit counts places them after
// the earlier windows' (one window while S*k <= 2^20; above, one pass over
// the list per window).  Its 32 warps then sum contiguous runs of the
// ordered list in f32, kSlotBatch rows in flight a lane (lanes 0..7 read
// the batch's entries and divisors), and the runs' sums are added in warp
// order and the row written once.  The list itself is left as the fill
// wrote it, so a second backward over the same transpose sorts it again.
template <typename T, int VEC>
__global__ void __launch_bounds__(kHeavyThreads)
gather_mean_bwd_heavy_kernel(const T* __restrict__ d_out, const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ entries, int32_t* sorted_entries,
                             const float* __restrict__ den_of,
                             const int32_t* __restrict__ heavy_rows,
                             const int32_t* __restrict__ n_heavy, T* __restrict__ d_h,
                             int64_t n_keys, int k, int F) {
  using V = typename Raw<VEC>::T;
  constexpr int E = VEC / (int)sizeof(T);
  extern __shared__ unsigned sm_bits[];  // [words], then [32 warps][32 lanes][E] partial sums
  __shared__ int32_t warp_total[32];
  const int64_t words64 = (n_keys + 31) / 32;
  const int words = (int)min64(words64, kHeavyWords);
  float* sm_part = reinterpret_cast<float*>(sm_bits + words);
  const int nvec = F / E;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rows = *n_heavy;
  for (int i = blockIdx.x; i < rows; i += gridDim.x) {
    const int64_t r = heavy_rows[i];
    const int b = offsets[r];
    const int n = offsets[r + 1] - b;
    const int32_t* unordered = entries + b;
    int32_t* list = sorted_entries + b;
    int placed = 0;  // keys of the earlier windows
    for (int64_t w0 = 0; w0 < n_keys; w0 += kWindowKeys) {
      const int w_words = (int)min64((n_keys - w0 + 31) / 32, kHeavyWords);
      for (int t = threadIdx.x; t < w_words; t += kHeavyThreads) sm_bits[t] = 0u;
      __syncthreads();
      for (int t = threadIdx.x; t < n; t += kHeavyThreads) {
        const int64_t e = unordered[t] - w0;
        if (e >= 0 && e < kWindowKeys) atomicOr(sm_bits + (e >> 5), 1u << (e & 31));
      }
      __syncthreads();
      const int per = (w_words + kHeavyThreads - 1) / kHeavyThreads;
      const int lo = threadIdx.x * per < w_words ? threadIdx.x * per : w_words;
      const int hi = lo + per < w_words ? lo + per : w_words;
      int own = 0;
      for (int t = lo; t < hi; ++t) own += __popc(sm_bits[t]);
      int32_t total;
      int pos = placed + block_exclusive_scan(own, warp_total, &total);
      for (int t = lo; t < hi; ++t)
        for (unsigned m = sm_bits[t]; m; m &= m - 1)
          list[pos++] = (int32_t)(w0 + t * 32 + __ffs(m) - 1);
      placed += total;
      __syncthreads();  // the bitmap is free; the ordered keys are visible to the block
    }
    const int run = (n + 31) / 32;
    const int lo = w * run < n ? w * run : n, hi = lo + run < n ? lo + run : n;
    V* orow = reinterpret_cast<V*>(d_h + r * F);
    for (int v0 = 0; v0 < nvec; v0 += 32) {
      const int v = v0 + lane;
      const bool live = v < nvec;
      float acc[E];
#pragma unroll
      for (int q = 0; q < E; ++q) acc[q] = 0.f;
      for (int t0 = lo; t0 < hi; t0 += kSlotBatch) {
        // lanes 0..7 take the batch's entries: their source rows and divisors
        int s = 0;
        float den = 1.f;
        if (lane < kSlotBatch && t0 + lane < hi) {
          s = list[t0 + lane] / k;
          den = den_of[s];
        }
        V raw[kSlotBatch];
        float dn[kSlotBatch];
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          const int64_t row = __shfl_sync(kFull, s, u);
          dn[u] = __shfl_sync(kFull, den, u);
          if (t0 + u < hi && live) raw[u] = reinterpret_cast<const V*>(d_out + row * F)[v];
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (t0 + u < hi && live) {
            const T* x = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
            for (int q = 0; q < E; ++q) acc[q] += to_float(x[q]) / dn[u];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < E; ++q) sm_part[(w * 32 + lane) * E + q] = acc[q];
      __syncthreads();
      if (w == 0 && live) {
        float sum[E];
#pragma unroll
        for (int q = 0; q < E; ++q) sum[q] = 0.f;
        for (int u = 0; u < 32; ++u)
#pragma unroll
          for (int q = 0; q < E; ++q) sum[q] += sm_part[(u * 32 + lane) * E + q];
        V res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int q = 0; q < E; ++q) o[q] = from_float<T>(sum[q]);
        orow[v] = res;
      }
      __syncthreads();  // sm_part and the bitmap are free
    }
  }
}

template <typename T, int VEC>
int launch_gather_mean_bwd(const void* d_out, TransposeWs tw, void* d_h, int64_t cap,
                           int64_t n_keys, int k, int F, cudaStream_t stream) {
  constexpr int E = VEC / (int)sizeof(T);
  const int64_t words = (n_keys + 31) / 32;
  const size_t part = 32 * 32 * E * sizeof(float);
  const size_t smem = (size_t)min64(words, kHeavyWords) * sizeof(unsigned) + part;
  auto heavy = gather_mean_bwd_heavy_kernel<T, VEC>;
  static int n_sm = 0;  // set once: the SMs of the first device this library launches on
  if (n_sm == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(heavy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(kHeavyWords * sizeof(unsigned) + part));
    if (err != cudaSuccess) return (int)err;
  }
  gather_mean_bwd_kernel<T, VEC><<<(unsigned)grid_for(cap), kThreads, 0, stream>>>(
      static_cast<const T*>(d_out), tw.offsets, tw.entries, tw.entry_den, static_cast<T*>(d_h), cap, k,
      F);
  heavy<<<(unsigned)n_sm, kHeavyThreads, smem, stream>>>(
      static_cast<const T*>(d_out), tw.offsets, tw.entries,
      reinterpret_cast<int32_t*>(tw.entry_den), tw.den, tw.heavy_rows, tw.n_heavy,
      static_cast<T*>(d_h), n_keys, k, F);
  return (int)cudaGetLastError();
}

// Instantiate LAUNCH<T, VEC> for the vector width `vec` (a bf16 may take
// 2-byte vectors, a float at least 4).
#define DG_DISPATCH_VEC(T, vec, LAUNCH, ...)                                  \
  switch (vec) {                                                              \
    case 16: return LAUNCH<T, 16>(__VA_ARGS__);                               \
    case 8: return LAUNCH<T, 8>(__VA_ARGS__);                                 \
    case 4: return LAUNCH<T, 4>(__VA_ARGS__);                                 \
    case 2:                                                                   \
      if constexpr (sizeof(T) == 2) return LAUNCH<T, 2>(__VA_ARGS__);         \
      return (int)cudaErrorInvalidValue;                                      \
    default: return (int)cudaErrorInvalidValue;                               \
  }

template <typename T>
int dispatch_gather_mean(const void* h, const int32_t* slots, const uint8_t* mask, void* out,
                         int64_t cap, int64_t S, int k, int F, cudaStream_t stream) {
  const int vec = vec_for(h, out, (int64_t)F * sizeof(T), sizeof(T));
  DG_DISPATCH_VEC(T, vec, launch_gather_mean, h, slots, mask, out, cap, S, k, F, stream)
}

template <typename T>
int dispatch_gather_mean_bwd(const void* d_out, TransposeWs tw, void* d_h, int64_t cap,
                             int64_t n_keys, int k, int F, cudaStream_t stream) {
  const int vec = vec_for(d_out, d_h, (int64_t)F * sizeof(T), sizeof(T));
  DG_DISPATCH_VEC(T, vec, launch_gather_mean_bwd, d_out, tw, d_h, cap, n_keys, k, F, stream)
}

}  // namespace

extern "C" {

// K1.  row_bytes = F * itemsize.  The load width (16, 8, 4, 2 or 1 bytes)
// divides row_bytes and both addresses; the store width is a multiple of it
// that divides a run's span and out's address.  L may be 0.
int dg_gather_rows(const void* table, const int32_t* idx, void* out,
                   int64_t n_rows, int64_t L, int64_t row_bytes, void* stream) {
  if (L == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = vec_for(table, out, row_bytes, 1);
  const int sv = vec_for(out, out, kRunRows * row_bytes, 1);  // a multiple of vec
  switch (vec) {
    case 16: return dispatch_gather_rows<16>(sv, table, idx, out, n_rows, L, row_bytes, s);
    case 8: return dispatch_gather_rows<8>(sv, table, idx, out, n_rows, L, row_bytes, s);
    case 4: return dispatch_gather_rows<4>(sv, table, idx, out, n_rows, L, row_bytes, s);
    case 2: return dispatch_gather_rows<2>(sv, table, idx, out, n_rows, L, row_bytes, s);
    default: return dispatch_gather_rows<1>(sv, table, idx, out, n_rows, L, row_bytes, s);
  }
}

// K2.  As K1, plus B = rows per stage (two stages of B * row_bytes in
// shared memory, which the wrapper has checked against
// dg_smem_optin_bytes).  L may be 0.
int dg_gather_rows_dma(const void* table, const int32_t* idx, void* out,
                       int64_t n_rows, int64_t L, int64_t row_bytes, int vec_bytes,
                       int B, void* stream) {
  if (L == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || B <= 0 || row_bytes % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_gather_rows_dma<16>(table, idx, out, n_rows, L, row_bytes, B, s);
    case 8: return launch_gather_rows_dma<8>(table, idx, out, n_rows, L, row_bytes, B, s);
    case 4: return launch_gather_rows_dma<4>(table, idx, out, n_rows, L, row_bytes, B, s);
    case 2: return launch_gather_rows_dma<2>(table, idx, out, n_rows, L, row_bytes, B, s);
    case 1: return launch_gather_rows_dma<1>(table, idx, out, n_rows, L, row_bytes, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a block may opt in to on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232448 bytes on an H100), or
// -1 if the query fails.
int64_t dg_smem_optin_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// K3, the slot form.  dtype 0 = float32, 1 = bfloat16.  h is [cap, F],
// slots and mask (one byte per bool) are [S, k], out is [S, F]; the vector
// width follows from F and the addresses of h and out.  With ws (else
// null), the same call then builds the slot table's transpose into it, as
// dg_slot_transpose does.
int dg_gather_mean(const void* h, const int32_t* slots, const uint8_t* mask, void* out,
                   int64_t cap, int64_t S, int k, int F, int dtype, int32_t* ws, void* stream) {
  if (S == 0) return 0;
  if (cap <= 0 || k <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = dispatch_gather_mean<float>(h, slots, mask, out, cap, S, k, F, st); break;
    case 1: rc = dispatch_gather_mean<__nv_bfloat16>(h, slots, mask, out, cap, S, k, F, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || ws == nullptr) return rc;
  return build_transpose(slots, mask, cap, S, k, ws, st);
}

// The transpose of an [S, k] slot table into ws (TransposeWs; the caller
// allocates cap + 1 + 2*S*k + S + 4 * (cap + 1) int32): offsets [cap + 1]
// at ws, then entries [S*k], flat indices s*k + j of the valid slots
// grouped by row, then their rows' divisors, then each row's divisor.
// Four launches chained by programmatic dependent launch, no memset.
int dg_slot_transpose(const int32_t* slots, const uint8_t* mask, int64_t cap, int64_t S, int k,
                      int32_t* ws, void* stream) {
  if (cap <= 0 || S < 0 || k < 0) return (int)cudaErrorInvalidValue;
  return build_transpose(slots, mask, cap, S, k, ws, static_cast<cudaStream_t>(stream));
}

// K3 backward.  dtype 0 = float32, 1 = bfloat16 (of d_out and d_h); d_out
// is [S, F], ws the transpose of the [S, k] slot table (dg_slot_transpose,
// or dg_gather_mean with ws), d_h [cap, F], every row written.  Two
// kernels: the rows with short lists, then the heavy rows.
int dg_gather_mean_bwd(const void* d_out, int32_t* ws, void* d_h, int64_t cap, int64_t S, int k,
                       int F, int dtype, void* stream) {
  if (cap == 0) return 0;
  if (cap < 0 || S < 0 || k < 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TransposeWs tw = transpose_ws(ws, cap, S, k);
  switch (dtype) {
    case 0: return dispatch_gather_mean_bwd<float>(d_out, tw, d_h, cap, S * k, k, F, st);
    case 1: return dispatch_gather_mean_bwd<__nv_bfloat16>(d_out, tw, d_h, cap, S * k, k, F, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
