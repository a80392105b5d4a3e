// K9 (dot-product attention scores over one sampled hop) and its backward,
// for Hopper, sm_90a.
//
// Plain C interface, loaded with ctypes by dist_gnn_tpu_torch/ops/attention.py
// (built by dist_gnn_tpu_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
// The launch geometry comes from ops/attention.py::attn_plan; the launchers
// check it against the layout below and refuse a plan that disagrees.
//
// Layouts: x_n [K, S, E] k-major neighbour inputs (K4's); qt [H, S, E], the
// query of every row and head folded through the key projection,
// qt[h, i] = W_k,h q_ih; mask [S, K] f32; s and ds [K, S, H] f32 (K4's er3).
// x_n, qt, dqt and dxn share one dtype, float32 or bfloat16.
//
// K9 dg_attn_score_fwd.  s[k, i, h] = scale * (qt[h, i] . x_n[k, i]) with f32
// sums, for the valid slots of row i, less the largest valid score of the
// row's head h (a constant of each row and head, so the softmax after it is
// unchanged); masked slots, and every slot of a row with none valid, get 0.
// K4 takes s as er3 with el = 0 and slope 1, and its one max over all of a
// row's K*H scores is then 0: no head's exponentials underflow because
// another head scores higher.
//   One warp per row: for each valid slot the warp reads x_n[k, i] once, in
//   V-wide coalesced loads, against the row's H query rows (H*E elements,
//   read from L1 after the first slot), and reduces the H partial sums by
//   shuffles; lane k keeps slot k's H scores for the per-head max.  Masked
//   slots are not read.  Bound: bytes (x_n's valid rows, read once).
//
// K9-bwd dg_attn_score_bwd.  For the scores' gradient ds (K5's d_er3; the
// shift is a constant, and a softmax's score gradients sum to 0 over a
// row's slots, so it passes ds through unchanged):
//   dqt[h, i] = scale * sum_k ds[k, i, h] x_n[k, i]        (written whole)
//   dxn[k, i] += scale * sum_h ds[k, i, h] qt[h, i]        (valid slots,
//                                                           when dxn is set)
//   One warp per row, lanes over V-wide column groups of E, f32 sums in
//   registers: for each group the warp takes the row's H query values once
//   and walks the valid slots, reading x_n (and dxn) once; lane k holds
//   slot k's H gradients and shuffles them to the warp.  dxn is K5's, added
//   to in place: one read and one write of the valid slots' rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block, one row each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 8;
constexpr int kMaxK = 32;
constexpr int kMaxE = 1024;
constexpr int kInvalid = (int)cudaErrorInvalidValue;
constexpr float kNeg = -1e30f;

// V consecutive values of T (V * sizeof(T) bytes aligned) to and from f32
template <typename T, int V> struct Vec;
template <int V> struct Vec<bf16, V> {
  using type = typename std::conditional<
      V == 8, uint4, typename std::conditional<V == 4, uint2,
                                               typename std::conditional<V == 2, uint32_t,
                                                                         uint16_t>::type>::type>::type;
};
template <int V> struct Vec<float, V> {
  using type = typename std::conditional<
      V == 4, float4, typename std::conditional<V == 2, float2, float>::type>::type;
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  using U = typename Vec<T, V>::type;
  const U u = __ldg(reinterpret_cast<const U*>(p));
  const T* b = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(b[j]);
}
// the same through the coherent path, for dxn, which this kernel writes
template <typename T, int V>
__device__ __forceinline__ void load_vec_rw(const T* p, float (&v)[V]) {
  using U = typename Vec<T, V>::type;
  const U u = *reinterpret_cast<const U*>(p);
  const T* b = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(b[j]);
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using U = typename Vec<T, V>::type;
  U u;
  T* b = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < V; ++j) b[j] = from_f32<T>(v[j]);
  *reinterpret_cast<U*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---- K9 ---------------------------------------------------------------------

template <typename T, int V, int kH>
__global__ void __launch_bounds__(kThreads)
attn_score_fwd_kernel(const T* __restrict__ x_n, const T* __restrict__ qt,
                      const float* __restrict__ mask, float* __restrict__ s, int K, int64_t S,
                      int E, int H, float scale) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= S) return;  // warp-uniform
  const float mine_mask = lane < K ? mask[i * K + lane] : 0.f;
  float mine[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) mine[h] = 0.f;
  for (int k = 0; k < K; ++k) {
    if (__shfl_sync(0xffffffffu, mine_mask, k) <= 0.f) continue;  // warp-uniform
    const T* xp = x_n + ((int64_t)k * S + i) * E;
    float acc[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) acc[h] = 0.f;
    for (int e = lane * V; e < E; e += 32 * V) {
      float xv[V];
      load_vec<T, V>(xp + e, xv);
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        if (h < H) {
          float qv[V];
          load_vec<T, V>(qt + ((int64_t)h * S + i) * E + e, qv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[h] += qv[v] * xv[v];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float t = h < H ? warp_sum(acc[h]) : 0.f;  // H is warp-uniform
      if (lane == k) mine[h] = t * scale;
    }
  }
  const bool valid = mine_mask > 0.f;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < H) {
      const float mx = warp_max(valid ? mine[h] : kNeg);
      if (lane < K) s[((int64_t)lane * S + i) * H + h] = valid ? mine[h] - mx : 0.f;
    }
  }
}

// ---- K9-bwd -----------------------------------------------------------------

template <typename T, int V, int kH>
__global__ void __launch_bounds__(kThreads)
attn_score_bwd_kernel(const T* __restrict__ x_n, const T* __restrict__ qt,
                      const float* __restrict__ mask, const float* __restrict__ ds,
                      T* dxn, T* __restrict__ dqt, int K, int64_t S, int E, int H, float scale) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= S) return;  // warp-uniform
  const float mine_mask = lane < K ? mask[i * K + lane] : 0.f;
  const unsigned live = __ballot_sync(0xffffffffu, mine_mask > 0.f);
  float mine[kH];  // slot lane's scaled score gradients
#pragma unroll
  for (int h = 0; h < kH; ++h)
    mine[h] = h < H && mine_mask > 0.f ? ds[((int64_t)lane * S + i) * H + h] * scale : 0.f;
  for (int e0 = 0; e0 < E; e0 += 32 * V) {  // warp-uniform: every lane takes the shuffles
    const int e = e0 + lane * V;
    const bool on = e < E;  // V divides E, so the whole group is in range
    float q[kH][V], dq[kH][V];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
#pragma unroll
      for (int v = 0; v < V; ++v) q[h][v] = dq[h][v] = 0.f;
      if (h < H && on) load_vec<T, V>(qt + ((int64_t)h * S + i) * E + e, q[h]);
    }
    for (unsigned rest = live; rest != 0; rest &= rest - 1) {  // the valid slots, in order
      const int k = __ffs(rest) - 1;
      float d[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) d[h] = __shfl_sync(0xffffffffu, mine[h], k);
      if (!on) continue;
      const int64_t off = ((int64_t)k * S + i) * E + e;
      float xv[V];
      load_vec<T, V>(x_n + off, xv);
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int v = 0; v < V; ++v) dq[h][v] += d[h] * xv[v];
      if (dxn != nullptr) {
        float dx[V];
        load_vec_rw<T, V>(dxn + off, dx);
#pragma unroll
        for (int h = 0; h < kH; ++h)
#pragma unroll
          for (int v = 0; v < V; ++v) dx[v] += d[h] * q[h][v];
        store_vec<T, V>(dxn + off, dx);
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h)
      if (h < H && on) store_vec<T, V>(dqt + ((int64_t)h * S + i) * E + e, dq[h]);
  }
}

// ---- launchers ----------------------------------------------------------------

bool plan_ok(int K, int64_t S, int E, int H, int rows, int grid) {
  return K > 0 && K <= kMaxK && S > 0 && E > 0 && E <= kMaxE && H > 0 && H <= kMaxHeads &&
         rows == kWarps && (int64_t)grid * rows >= S && (int64_t)(grid - 1) * rows < S;
}

// the widest V (max_v, halved down to 1) that divides E and keeps every
// pointer's rows V-element aligned
int vec_of(int E, int max_v, int elem, const void* a, const void* b, const void* c) {
  for (int v = max_v; v > 1; v /= 2) {
    const uintptr_t align = (uintptr_t)v * elem;
    if (E % v == 0 && (uintptr_t)a % align == 0 && (uintptr_t)b % align == 0 &&
        (uintptr_t)c % align == 0)
      return v;
  }
  return 1;
}

template <typename T, int V>
int fwd_v(const T* x_n, const T* qt, const float* mask, float* s, int K, int64_t S, int E, int H,
          float scale, int grid, cudaStream_t st) {
  if (H <= 4)
    attn_score_fwd_kernel<T, V, 4><<<grid, kThreads, 0, st>>>(x_n, qt, mask, s, K, S, E, H, scale);
  else
    attn_score_fwd_kernel<T, V, 8><<<grid, kThreads, 0, st>>>(x_n, qt, mask, s, K, S, E, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd_v(const T* x_n, const T* qt, const float* mask, const float* ds, T* dxn, T* dqt, int K,
          int64_t S, int E, int H, float scale, int grid, cudaStream_t st) {
  if (H <= 4)
    attn_score_bwd_kernel<T, V, 4><<<grid, kThreads, 0, st>>>(x_n, qt, mask, ds, dxn, dqt, K, S,
                                                              E, H, scale);
  else
    attn_score_bwd_kernel<T, V, 8><<<grid, kThreads, 0, st>>>(x_n, qt, mask, ds, dxn, dqt, K, S,
                                                              E, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int kMaxV>
int launch_fwd(const T* x_n, const T* qt, const float* mask, float* s, int K, int64_t S, int E,
               int H, float scale, int grid, cudaStream_t st) {
  switch (vec_of(E, kMaxV, sizeof(T), x_n, qt, qt)) {
    case 8:
      if constexpr (kMaxV >= 8) return fwd_v<T, 8>(x_n, qt, mask, s, K, S, E, H, scale, grid, st);
      return kInvalid;
    case 4: return fwd_v<T, 4>(x_n, qt, mask, s, K, S, E, H, scale, grid, st);
    case 2: return fwd_v<T, 2>(x_n, qt, mask, s, K, S, E, H, scale, grid, st);
    default: return fwd_v<T, 1>(x_n, qt, mask, s, K, S, E, H, scale, grid, st);
  }
}

template <typename T, int kMaxV>
int launch_bwd(const T* x_n, const T* qt, const float* mask, const float* ds, T* dxn, T* dqt,
               int K, int64_t S, int E, int H, float scale, int grid, cudaStream_t st) {
  const void* third = dxn != nullptr ? static_cast<const void*>(dxn) : static_cast<const void*>(dqt);
  switch (vec_of(E, kMaxV, sizeof(T), x_n, qt, third)) {
    case 8:
      if constexpr (kMaxV >= 8)
        return bwd_v<T, 8>(x_n, qt, mask, ds, dxn, dqt, K, S, E, H, scale, grid, st);
      return kInvalid;
    case 4: return bwd_v<T, 4>(x_n, qt, mask, ds, dxn, dqt, K, S, E, H, scale, grid, st);
    case 2: return bwd_v<T, 2>(x_n, qt, mask, ds, dxn, dqt, K, S, E, H, scale, grid, st);
    default: return bwd_v<T, 1>(x_n, qt, mask, ds, dxn, dqt, K, S, E, H, scale, grid, st);
  }
}

}  // namespace

extern "C" {

// K9.  dtype 0 = float32, 1 = bfloat16 (of x_n and qt).  rows (warps a
// block, one row each) and grid are ops/attention.py::attn_plan's; a plan
// that disagrees with this source is refused with cudaErrorInvalidValue
// before any launch.
int dg_attn_score_fwd(const void* x_n, const void* qt, const float* mask, float* s, int K,
                      int64_t S, int E, int H, float scale, int dtype, int rows, int grid,
                      void* stream) {
  if (!plan_ok(K, S, E, H, rows, grid)) return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float, 4>(static_cast<const float*>(x_n), static_cast<const float*>(qt),
                                  mask, s, K, S, E, H, scale, grid, st);
    case 1:
      return launch_fwd<bf16, 8>(static_cast<const bf16*>(x_n), static_cast<const bf16*>(qt),
                                 mask, s, K, S, E, H, scale, grid, st);
    default:
      return kInvalid;
  }
}

// K9-bwd.  ds [K, S, H] f32; dqt [H, S, E] written whole; dxn [K, S, E]
// added to at the valid slots, or null to skip d_x.
int dg_attn_score_bwd(const void* x_n, const void* qt, const float* mask, const float* ds,
                      void* dxn, void* dqt, int K, int64_t S, int E, int H, float scale,
                      int dtype, int rows, int grid, void* stream) {
  if (!plan_ok(K, S, E, H, rows, grid)) return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float, 4>(static_cast<const float*>(x_n), static_cast<const float*>(qt),
                                  mask, ds, static_cast<float*>(dxn), static_cast<float*>(dqt), K,
                                  S, E, H, scale, grid, st);
    case 1:
      return launch_bwd<bf16, 8>(static_cast<const bf16*>(x_n), static_cast<const bf16*>(qt),
                                 mask, ds, static_cast<bf16*>(dxn), static_cast<bf16*>(dqt), K, S,
                                 E, H, scale, grid, st);
    default:
      return kInvalid;
  }
}

}  // extern "C"
