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
//   each distinct row read once plus the output written once.  Design: one
//   warp per output row, lanes copy the row in the widest vector that
//   divides the row and the base pointers (16 B for 512-byte rows, 8 B for
//   the 200-byte rows of bf16 F=100, whose starts are only 8-byte aligned),
//   so every row is one contiguous, coalesced warp access.  The TPU's F%128
//   and SMEM chunk limits are gone.
//
// K3 dg_gather_mean: out[s] = sum_{valid j} h[slots[s,j]] / max(cnt_s, 1),
//   rows with no valid slot give 0, no [S, k, F] intermediate.  Replaces
//   gather_pallas.py _gather_sum_chunk (kernel _gather_sum_kernel), which
//   redirected masked slots to an appended zero row; here masked slots are
//   skipped, so h is never copied.  Bound by bytes: the distinct valid rows
//   of h read once, slots and mask read once, the output written once.
//   Design: one warp per destination row; each lane owns a vector of the
//   row and sums it over the k slots in f32 registers, then divides and
//   writes once in the input dtype.  (The Pallas kernel accumulated in the
//   table dtype; f32 here, so bf16 results differ from it by rounding.)
//
// K3 backward dg_gather_mean_bwd: d_h[slots[s,j]] += d_out[s] / max(cnt_s, 1)
//   over valid j, into a zeroed f32 [cap, F] buffer.  The Pallas package has
//   no backward kernel for K3 (its SAGE differentiates the jnp mean through
//   XLA); this is the port's own.  Bound by bytes: d_out, slots and mask
//   read once, the distinct rows of d_h written once (the plain version
//   materialises the [S*k, F] repeated rows, k times the bytes).  Design:
//   one warp per destination row, each lane scales its elements of d_out[s]
//   once and adds them into every valid slot's row with f32 atomics, which
//   take the duplicate slots of a row and of different rows alike.  The
//   wrapper casts the f32 sum once to h's dtype.  Atomics commit in no fixed
//   order, so the last bits of an f32 sum vary from run to run.
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

int64_t grid_for(int64_t rows) {
  int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// ---- K1 -------------------------------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const typename Raw<VEC>::T* __restrict__ table,
                   const int32_t* __restrict__ idx,
                   typename Raw<VEC>::T* __restrict__ out, int64_t n_rows,
                   int64_t L, int vpr) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < L; i += n_warps) {
    const int64_t r = clamp_row(idx[i], n_rows);
    const typename Raw<VEC>::T* src = table + r * vpr;
    typename Raw<VEC>::T* dst = out + i * vpr;
    for (int v = lane; v < vpr; v += 32) dst[v] = src[v];
  }
}

template <int VEC>
void launch_gather_rows(const void* table, const int32_t* idx, void* out,
                        int64_t n_rows, int64_t L, int64_t row_bytes,
                        cudaStream_t stream) {
  using V = typename Raw<VEC>::T;
  gather_rows_kernel<VEC><<<(unsigned)grid_for(L), kThreads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), n_rows, L,
      (int)(row_bytes / VEC));
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_mean_kernel(const T* __restrict__ h, const int32_t* __restrict__ slots,
                   const uint8_t* __restrict__ mask, T* __restrict__ out,
                   int64_t cap, int64_t S, int k, int F) {
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
    for (int j = 0; j < k; ++j) cnt += mrow[j] != 0;
    const float denom = (float)(cnt > 1 ? cnt : 1);
    V* orow = reinterpret_cast<V*>(out + s * F);
    for (int v = lane; v < nvec; v += 32) {
      float acc[E];
#pragma unroll
      for (int q = 0; q < E; ++q) acc[q] = 0.f;
      for (int j = 0; j < k; ++j) {
        if (!mrow[j]) continue;
        const int64_t r = clamp_row(srow[j], cap);
        const V raw = reinterpret_cast<const V*>(h + r * F)[v];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < E; ++q) acc[q] += to_float(e[q]);
      }
      V res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int q = 0; q < E; ++q) o[q] = from_float<T>(acc[q] / denom);
      orow[v] = res;
    }
  }
}

template <typename T, int VEC>
void launch_gather_mean(const void* h, const int32_t* slots,
                        const uint8_t* mask, void* out, int64_t cap, int64_t S,
                        int k, int F, cudaStream_t stream) {
  gather_mean_kernel<T, VEC><<<(unsigned)grid_for(S), kThreads, 0, stream>>>(
      static_cast<const T*>(h), slots, mask, static_cast<T*>(out), cap, S, k,
      F);
}

template <typename T>
int dispatch_gather_mean(const void* h, const int32_t* slots,
                         const uint8_t* mask, void* out, int64_t cap,
                         int64_t S, int k, int F, int vec_bytes,
                         cudaStream_t stream) {
  switch (vec_bytes) {
    case 16: launch_gather_mean<T, 16>(h, slots, mask, out, cap, S, k, F, stream); break;
    case 8: launch_gather_mean<T, 8>(h, slots, mask, out, cap, S, k, F, stream); break;
    case 4: launch_gather_mean<T, 4>(h, slots, mask, out, cap, S, k, F, stream); break;
    case 2:  // one bf16 per lane vector; a float needs at least 4 bytes
      if constexpr (sizeof(T) == 2) {
        launch_gather_mean<T, 2>(h, slots, mask, out, cap, S, k, F, stream);
        break;
      } else {
        return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- K3 backward ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_mean_bwd_kernel(const T* __restrict__ d_out,
                       const int32_t* __restrict__ slots,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ d_h, int64_t cap, int64_t S, int k,
                       int F) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < S; s += n_warps) {
    const int32_t* srow = slots + s * k;
    const uint8_t* mrow = mask + s * k;
    int cnt = 0;
    for (int j = 0; j < k; ++j) cnt += mrow[j] != 0;
    if (cnt == 0) continue;
    const float denom = (float)cnt;
    for (int f = lane; f < F; f += 32) {
      const float g = to_float(d_out[s * F + f]) / denom;
      for (int j = 0; j < k; ++j) {
        if (mrow[j]) atomicAdd(d_h + clamp_row(srow[j], cap) * F + f, g);
      }
    }
  }
}

}  // namespace

extern "C" {

// K1.  row_bytes = F * itemsize; vec_bytes in {16, 8, 4, 2, 1} divides
// row_bytes and the alignment of table and out.  L may be 0.
int dg_gather_rows(const void* table, const int32_t* idx, void* out,
                   int64_t n_rows, int64_t L, int64_t row_bytes, int vec_bytes,
                   void* stream) {
  if (L == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch_gather_rows<16>(table, idx, out, n_rows, L, row_bytes, s); break;
    case 8: launch_gather_rows<8>(table, idx, out, n_rows, L, row_bytes, s); break;
    case 4: launch_gather_rows<4>(table, idx, out, n_rows, L, row_bytes, s); break;
    case 2: launch_gather_rows<2>(table, idx, out, n_rows, L, row_bytes, s); break;
    case 1: launch_gather_rows<1>(table, idx, out, n_rows, L, row_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

// K3.  dtype 0 = float32, 1 = bfloat16.  h is [cap, F], slots and mask
// (one byte per bool) are [S, k], out is [S, F]; vec_bytes divides
// F * itemsize and the alignment of h and out.
int dg_gather_mean(const void* h, const int32_t* slots, const uint8_t* mask,
                   void* out, int64_t cap, int64_t S, int k, int F, int dtype,
                   int vec_bytes, void* stream) {
  if (S == 0) return 0;
  if (cap <= 0 || k <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_gather_mean<float>(h, slots, mask, out, cap, S, k, F, vec_bytes, s);
    case 1:
      return dispatch_gather_mean<__nv_bfloat16>(h, slots, mask, out, cap, S, k, F, vec_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3 backward.  dtype 0 = float32, 1 = bfloat16 (of d_out); d_out is
// [S, F], slots and mask [S, k], d_h a zeroed f32 [cap, F] buffer.
int dg_gather_mean_bwd(const void* d_out, const int32_t* slots,
                       const uint8_t* mask, float* d_h, int64_t cap, int64_t S,
                       int k, int F, int dtype, void* stream) {
  if (S == 0) return 0;
  if (cap <= 0 || k <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)grid_for(S);
  switch (dtype) {
    case 0:
      gather_mean_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(d_out), slots, mask, d_h, cap, S, k, F);
      break;
    case 1:
      gather_mean_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(d_out), slots, mask, d_h, cap, S,
          k, F);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
